"""chip_smoke.py's phases at TINY_TEST widths on the CPU (kernels
interpreted), and its refusal to run without a GPU."""
import collections
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from zgml.utils.synthetic import TINY_TEST  # noqa: E402


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    from zgml.io.gguf import GGMLType
    from zgml.io.llama_loader import load_llama
    from zgml.utils.synthetic import write_synthetic_llama_gguf
    path = str(tmp_path_factory.mktemp("smoke") / "tiny_q4.gguf")
    write_synthetic_llama_gguf(path, TINY_TEST, GGMLType.Q4_0, seed=4)
    model, _ = load_llama(path, mode="quantized")
    return model


def test_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code != 0


def test_main_prints_no_result_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_phase_kernels_tiny():
    rows = chip_smoke.phase_kernels(TINY_TEST, ms=(1, 8), kv_lens=(1, 30, 63),
                                    q_offsets=(0, 16), chunk=16, reps=0)
    assert len(rows) == 2 * 5 * 2 + 3 + 2
    assert {r["impl"] for r in rows if r["name"].startswith("qmatmul")} == {
        "interpret"}
    assert all(r["ok"] for r in rows)


def test_phase_engine_tiny(tiny_model):
    placement = chip_smoke.Placement()
    out = chip_smoke.phase_engine(tiny_model, placement, prompt_len=40,
                                  chunk=16, n_decode=8)
    assert set(out) == {"bf16", "int8"}
    assert all(v["cos_step"] >= chip_smoke.COS_MIN for v in out.values())
    assert placement.counts[("qmatmul", "interpret")] > 0
    assert not any(t == "ref" for _, t in placement.counts)


def test_phase_serving_tiny(tiny_model):
    reqs = ((5, 4), (40, 6), (17, 3), (9, 5))
    outs = chip_smoke.phase_serving(tiny_model, chip_smoke.Placement(),
                                    requests=reqs, max_batch=4, chunk=16)
    assert [len(o) for o in outs.values()] == [n for _, n in reqs]


@pytest.mark.parametrize("tier", ["ref", "interpret"])
def test_phase_placement_rejects(tier):
    counts = collections.Counter({("qmatmul", "triton"): 3,
                                  ("decode_attention", "triton"): 2,
                                  ("attention", tier): 1})
    with pytest.raises(AssertionError, match="oracle or the interpreter"):
        chip_smoke.phase_placement(counts)


def test_phase_placement_accepts_compiled():
    chip_smoke.phase_placement(collections.Counter({
        ("qmatmul", "triton"): 3, ("decode_attention", "triton"): 2,
        ("attention", "xla"): 1, ("rmsnorm", "xla"): 4}))
