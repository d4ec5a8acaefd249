"""Train a byte-level BPE on the repo's own documentation and tokenize it —
the zero-egress stand-in for WikiText-2.

Emits:
  tests/data/bpe/vocab.json + merges.txt   (loadable by BPETokenizer.from_files)
  tests/data/corpus_tokens.npy             (int32 ids, natural zipfian stream)

The encoder pipeline is the real one: the exact GPT-2 pre-tokenizer scanner +
iterative lowest-rank merge from zgml.io.tokenizer (ref:
src/tokenizer.zig:19-379); only the merge table is learned here instead of
downloaded.

Usage: python tools/make_corpus.py [n_merges=4000]
"""
from __future__ import annotations

import collections
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from zgml.io.tokenizer import _BYTE_ENCODER, BPETokenizer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def corpus_text() -> str:
    paths = sorted(
        glob.glob(os.path.join(REPO, "*.md"))
        + glob.glob(os.path.join(REPO, "docs", "*.md")))
    parts = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            parts.append(f.read())
    return "\n\n".join(parts)


def train_bpe(text: str, n_merges: int):
    """Classic BPE training over pre-tokenized word frequencies."""
    pretok = BPETokenizer({}, [])._split_pretok(text)
    words = collections.Counter(
        tuple("".join(_BYTE_ENCODER[b] for b in w.encode("utf-8")))
        for w in pretok)
    merges: list[tuple[str, str]] = []
    vocab_syms = sorted({c for w in words for c in w})
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, c in words.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] += c
        if not pairs:
            break
        (a, b), cnt = pairs.most_common(1)[0]
        if cnt < 2:
            break
        merges.append((a, b))
        ab = a + b
        vocab_syms.append(ab)
        new_words = {}
        for w, c in words.items():
            if a not in w:
                new_words[w] = new_words.get(w, 0) + c
                continue
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(ab)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            t = tuple(out)
            new_words[t] = new_words.get(t, 0) + c
        words = new_words
    vocab = {s: i for i, s in enumerate(dict.fromkeys(vocab_syms))}
    return vocab, merges


def main():
    import numpy as np
    n_merges = int(sys.argv[1]) if len(sys.argv) > 1 else 4000
    text = corpus_text()
    print(f"corpus: {len(text)} chars from repo docs")
    vocab, merges = train_bpe(text, n_merges)
    print(f"trained: {len(vocab)} vocab, {len(merges)} merges")

    outdir = os.path.join(REPO, "tests", "data", "bpe")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "vocab.json"), "w") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(outdir, "merges.txt"), "w") as f:
        f.write("#version: zgml repo-docs bpe\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")

    tok = BPETokenizer.from_files(os.path.join(outdir, "vocab.json"),
                                  os.path.join(outdir, "merges.txt"))
    ids = np.asarray(tok.encode(text), np.int32)
    out = os.path.join(REPO, "tests", "data", "corpus_tokens.npy")
    np.save(out, ids)
    # quick sanity: decode roundtrip + natural statistics
    rt = tok.decode(ids.tolist())
    uniq = len(np.unique(ids))
    top = collections.Counter(ids.tolist()).most_common(1)[0][1]
    print(f"tokens: {len(ids)} ({uniq} unique, top freq {top}, "
          f"chars/token {len(text)/len(ids):.2f}) -> {out}")
    assert rt == text, "BPE decode roundtrip failed"


if __name__ == "__main__":
    main()
