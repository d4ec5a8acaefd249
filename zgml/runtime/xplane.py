"""Minimal XSpace/XPlane protobuf wire-format reader (dependency-free).

jax.profiler.trace writes `*.xplane.pb` (an XSpace proto: planes -> lines ->
events with ps offsets/durations). The full parsers (tensorflow /
tensorboard_plugin_profile) are version-locked to their own generated protos
and break against the installed protobuf runtime, so this module walks the
wire format directly for just the fields the per-step profiler needs.

This powers the analog of the reference's per-step execution profile with
tensor-layout annotations (src/graph.zig:911-1112): real device-timeline
per-op durations AND the gaps between ops, from the compiled step itself.

Wire schema (tsl/profiler/protobuf/xplane.proto):
  XSpace:  planes = 1 (msg)
  XPlane:  id = 1, name = 2, lines = 3 (msg), event_metadata = 4 (map),
           stat_metadata = 5 (map)
  XLine:   id = 1, name = 2, timestamp_ns = 3, events = 4 (msg),
           duration_ps = 9, display_name = 11
  XEvent:  metadata_id = 1, offset_ps = 2, duration_ps = 3, stats = 4
  XEventMetadata: id = 1, name = 2
  map entry: key = 1, value = 2
"""
from __future__ import annotations

import dataclasses


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer.
    value: int for varint/fixed, bytes for length-delimited."""
    i, n = 0, len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:                       # varint
            v, i = _read_varint(buf, i)
        elif wt == 2:                     # length-delimited
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:                     # fixed32
            v = int.from_bytes(buf[i:i + 4], "little")
            i += 4
        elif wt == 1:                     # fixed64
            v = int.from_bytes(buf[i:i + 8], "little")
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fnum, wt, v


@dataclasses.dataclass
class Event:
    name: str
    offset_ps: int
    duration_ps: int


@dataclasses.dataclass
class Line:
    name: str
    timestamp_ns: int
    events: list


@dataclasses.dataclass
class Plane:
    name: str
    lines: list


def _parse_event(buf: bytes, md: dict) -> Event:
    mid = off = dur = 0
    for f, _, v in _fields(buf):
        if f == 1:
            mid = v
        elif f == 2:
            off = v
        elif f == 3:
            dur = v
    return Event(md.get(mid, f"meta:{mid}"), off, dur)


def _parse_line(buf: bytes, md: dict) -> Line:
    name, ts, events = "", 0, []
    for f, _, v in _fields(buf):
        if f == 2:
            name = v.decode("utf-8", "replace")
        elif f == 3:
            ts = v
        elif f == 4:
            events.append(_parse_event(v, md))
    return Line(name, ts, events)


def _parse_meta_entry(buf: bytes) -> tuple[int, str]:
    key, name = 0, ""
    for f, _, v in _fields(buf):
        if f == 1:
            key = v
        elif f == 2:                      # XEventMetadata
            for f2, _, v2 in _fields(v):
                if f2 == 1:
                    key = key or v2
                elif f2 == 2:
                    name = v2.decode("utf-8", "replace")
    return key, name


def _parse_plane(buf: bytes) -> Plane:
    name = ""
    line_bufs = []
    md: dict[int, str] = {}
    for f, _, v in _fields(buf):
        if f == 2:
            name = v.decode("utf-8", "replace")
        elif f == 3:
            line_bufs.append(v)
        elif f == 4:
            k, n = _parse_meta_entry(v)
            md[k] = n
    return Plane(name, [_parse_line(b, md) for b in line_bufs])


def parse_xspace(path: str) -> list[Plane]:
    buf = open(path, "rb").read()
    return [_parse_plane(v) for f, _, v in _fields(buf) if f == 1]


def device_planes(planes: list[Plane]) -> list[Plane]:
    """The GPU device planes ("/device:GPU:<n>"); a trace without one did not
    record the card, which is an error, not an empty profile."""
    found = [p for p in planes if p.name.startswith("/device:GPU")]
    if not found:
        raise ValueError("no /device:GPU plane in the trace (planes: "
                         f"{[p.name for p in planes]})")
    return found


def window_stats(events: list[Event]) -> tuple[int, int]:
    """(window, busy) in ps over device events: the window runs from the
    first start to the last end; busy is the union of the events'
    intervals, so the idle share is 1 - busy / window."""
    spans = sorted((e.offset_ps, e.offset_ps + e.duration_ps) for e in events)
    if not spans:
        raise ValueError("no device events")
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return max(e for _, e in spans) - spans[0][0], busy
