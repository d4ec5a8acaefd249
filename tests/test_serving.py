"""Continuous batching tests: correctness vs single-request engine, slot
reuse, mid-flight admission."""
import numpy as np
import jax.numpy as jnp
import pytest

from zgml.io.gguf import GGMLType
from zgml.io.llama_loader import load_llama
from zgml.runtime.engine import LlamaEngine
from zgml.runtime.serving import ContinuousBatchingEngine
from zgml.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "t.gguf"
    write_synthetic_llama_gguf(str(path), TINY_TEST, GGMLType.Q8_0, seed=9)
    m, _ = load_llama(str(path), mode="dense")
    return m


def test_batched_decode_matches_single(model):
    """Each request's tokens must equal what the single-request engine
    produces (greedy)."""
    prompts = [[1, 2, 3], [10, 20, 30, 40], [7]]
    singles = []
    for p in prompts:
        eng = LlamaEngine(model, donate_cache=False)
        singles.append(eng.generate(p, 6))

    serve = ContinuousBatchingEngine(model, max_batch=4)
    outs = serve.run([(p, 6) for p in prompts])
    got = [outs[rid] for rid in sorted(outs)]
    assert got == singles, (got, singles)


def test_more_requests_than_slots(model):
    """Slot reuse: 5 requests through 2 slots."""
    prompts = [[i + 1, i + 2] for i in range(5)]
    singles = []
    for p in prompts:
        eng = LlamaEngine(model, donate_cache=False)
        singles.append(eng.generate(p, 4))
    serve = ContinuousBatchingEngine(model, max_batch=2)
    outs = serve.run([(p, 4) for p in prompts])
    got = [outs[rid] for rid in sorted(outs)]
    assert got == singles


def test_mid_flight_admission(model):
    """A request submitted while another is decoding must not disturb it."""
    eng = LlamaEngine(model, donate_cache=False)
    want_a = eng.generate([5, 6, 7], 8)

    serve = ContinuousBatchingEngine(model, max_batch=2)
    emissions: dict[int, list[int]] = {}
    rid_a = serve.submit([5, 6, 7], 8)
    for _ in range(3):
        for rid, t in serve.step():
            emissions.setdefault(rid, []).append(t)
    rid_b = serve.submit([9, 9], 5)   # joins while rid_a is mid-decode
    while any(s is not None for s in serve.slots) or serve.waiting:
        for rid, t in serve.step():
            emissions.setdefault(rid, []).append(t)
    # rid_a's decode emissions (prefill's first token is not emitted by step)
    assert emissions[rid_a] == want_a[1:]
    eng2 = LlamaEngine(model, donate_cache=False)
    want_b = eng2.generate([9, 9], 5)
    assert emissions[rid_b] == want_b[1:]


def test_int8_cache_serving(model):
    serve = ContinuousBatchingEngine(model, max_batch=2, cache_dtype="int8")
    outs = serve.run([([1, 2, 3], 4), ([4, 5], 4)])
    assert all(len(v) == 4 for v in outs.values())


def test_burst_matches_stepwise(model):
    """decode_burst (N tokens per dispatch) must emit the same greedy streams
    as per-step decoding, including stop-overshoot truncation."""
    prompts = [[1, 2, 3], [10, 20, 30, 40], [5, 6]]
    a = ContinuousBatchingEngine(model, max_batch=4)
    want = a.run([(p, 9) for p in prompts])
    b = ContinuousBatchingEngine(model, max_batch=4)
    got = b.run([(p, 9) for p in prompts], burst=4)
    assert [got[r] for r in sorted(got)] == [want[r] for r in sorted(want)]


def test_chunked_admission_interleaves(model):
    """A long prompt must NOT stall decoding slots: with prefill_chunk=4 and
    an 11-token prompt, already-decoding requests keep emitting on the steps
    that also carry a prefill chunk."""
    serve = ContinuousBatchingEngine(model, max_batch=2, prefill_chunk=4)
    r0 = serve.submit([1, 2, 3], 12)
    # get r0 decoding
    for _ in range(3):
        serve.step()
    r1 = serve.submit(list(range(1, 12)), 4)   # 11 tokens -> 3 chunks
    emitted_during_prefill = 0
    for _ in range(3):                          # the 3 prefill-chunk steps
        out = serve.step()
        emitted_during_prefill += sum(1 for rid, _ in out if rid == r0)
    assert emitted_during_prefill >= 3, emitted_during_prefill
    # drain; both complete with correct counts
    while any(s is not None for s in serve.slots) or serve.prefilling:
        serve.step()
    reqs = {r0: 12, r1: 4}
    # r0 emitted every step it was active; r1's output matches the single
    # engine on the same prompt
    single = LlamaEngine(model, donate_cache=False)
    assert single.generate(list(range(1, 12)), 4) == serve.requests[r1].output


def test_mesh_serving_matches_single(model):
    """TP+dp sharded serving (shard_map decode/prefill/burst) must produce
    the same greedy streams as the unsharded engine."""
    import jax
    from zgml.models.llama import LlamaModel
    from zgml.parallel import make_mesh
    from zgml.parallel.tp import shard_llama_params

    prompts = [[1, 2, 3], [10, 20, 30, 40], [7], [9, 8]]
    singles = []
    for p in prompts:
        eng = LlamaEngine(model, donate_cache=False)
        singles.append(eng.generate(p, 6))

    mesh = make_mesh(tp=2, dp=2, devices=jax.devices()[:4])
    params = shard_llama_params(model.params, mesh, model.cfg)
    model_sh = LlamaModel(model.cfg, params)
    serve = ContinuousBatchingEngine(model_sh, max_batch=4, mesh=mesh)
    outs = serve.run([(p, 6) for p in prompts])
    got = [outs[rid] for rid in sorted(outs)]
    assert got == singles, (got, singles)


def test_mesh_serving_burst_and_slot_reuse(model):
    """Mesh serving: more requests than slots + burst decode (scan inside
    shard_map) still match the single-request engine."""
    import jax
    from zgml.models.llama import LlamaModel
    from zgml.parallel import make_mesh
    from zgml.parallel.tp import shard_llama_params

    prompts = [[i + 1, i + 2, i + 3] for i in range(5)]
    singles = []
    for p in prompts:
        eng = LlamaEngine(model, donate_cache=False)
        singles.append(eng.generate(p, 4))

    mesh = make_mesh(tp=2, dp=1, devices=jax.devices()[:2])
    params = shard_llama_params(model.params, mesh, model.cfg)
    model_sh = LlamaModel(model.cfg, params)
    serve = ContinuousBatchingEngine(model_sh, max_batch=2, mesh=mesh)
    outs = serve.run([(p, 4) for p in prompts], burst=4)
    got = [outs[rid] for rid in sorted(outs)]
    assert got == singles, (got, singles)
