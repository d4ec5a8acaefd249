"""xplane wire-format reader vs a hand-encoded XSpace proto buffer.

The profiler harness (tools/profile_trace.py) depends on this parser; the
stock proto parsers are version-locked, so correctness is checked against
bytes assembled from the wire format directly.
"""
import numpy as np

from zgml.runtime.xplane import parse_xspace


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(fnum: int, wt: int, payload) -> bytes:
    tag = _varint((fnum << 3) | wt)
    if wt == 0:
        return tag + _varint(payload)
    return tag + _varint(len(payload)) + payload


def test_parse_minimal_xspace(tmp_path):
    ev1 = (_field(1, 0, 1)          # metadata_id
           + _field(2, 0, 100)      # offset_ps
           + _field(3, 0, 50))      # duration_ps
    ev2 = (_field(1, 0, 2)
           + _field(2, 0, 200)
           + _field(3, 0, 75))
    line = (_field(2, 2, b"XLA Ops")
            + _field(3, 0, 123456789)           # timestamp_ns
            + _field(4, 2, ev1)
            + _field(4, 2, ev2))
    md1 = _field(1, 0, 1) + _field(2, 2, b"%fusion.1 = f32[8]{0} ...")
    md2 = _field(1, 0, 2) + _field(2, 2, b"%custom-call.7")
    plane = (_field(2, 2, b"/device:GPU:0")
             + _field(3, 2, line)
             + _field(4, 2, _field(1, 0, 1) + _field(2, 2, md1))
             + _field(4, 2, _field(1, 0, 2) + _field(2, 2, md2)))
    space = _field(1, 2, plane)

    p = tmp_path / "t.xplane.pb"
    p.write_bytes(space)
    planes = parse_xspace(str(p))
    assert len(planes) == 1
    pl = planes[0]
    assert pl.name == "/device:GPU:0"
    assert len(pl.lines) == 1
    ln = pl.lines[0]
    assert ln.name == "XLA Ops"
    assert ln.timestamp_ns == 123456789
    assert [(e.name, e.offset_ps, e.duration_ps) for e in ln.events] == [
        ("%fusion.1 = f32[8]{0} ...", 100, 50),
        ("%custom-call.7", 200, 75),
    ]
    assert int(np.sum([e.duration_ps for e in ln.events])) == 125


def _plane(name: bytes) -> bytes:
    return _field(2, 2, name)


def test_device_planes_selects_gpu(tmp_path):
    from zgml.runtime.xplane import device_planes
    space = b"".join(_field(1, 2, _plane(n)) for n in
                     (b"/host:CPU", b"/device:GPU:0", b"/device:GPU:1"))
    p = tmp_path / "t.xplane.pb"
    p.write_bytes(space)
    got = device_planes(parse_xspace(str(p)))
    assert [pl.name for pl in got] == ["/device:GPU:0", "/device:GPU:1"]


def test_device_planes_without_gpu_fails(tmp_path):
    import pytest
    from zgml.runtime.xplane import device_planes
    p = tmp_path / "t.xplane.pb"
    p.write_bytes(_field(1, 2, _plane(b"/host:CPU")))
    with pytest.raises(ValueError, match="no /device:GPU plane"):
        device_planes(parse_xspace(str(p)))


def test_window_stats_union_of_overlaps():
    from zgml.runtime.xplane import Event, window_stats
    evs = [Event("a", 0, 10), Event("b", 5, 10), Event("c", 30, 10)]
    assert window_stats(evs) == (40, 25)      # idle 15 of 40 ps
