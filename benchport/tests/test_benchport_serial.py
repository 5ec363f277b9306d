"""The serial cell's room for a faster player: a stream that outlasts the
window, a check whose reference reads only the kept calls' units, and a
traced window of at most CHECK_CALLS calls."""

import json
import os

import numpy as np
import pytest

from harness import check, content, drivers, entropy, iamf_bits as ib

from conftest import BENCH, ROOT


def _cfg():
    return json.load(open(os.path.join(BENCH, "configs",
                                       "opus714_ssJ.json")))


def _sample():
    return open(os.path.join(BENCH, "data", "sample_opus_714.iamf"),
                "rb").read()


class StubDecoder:
    """An IAMFDecoder stand-in: every decode() takes one byte and returns
    at once a fixed-size unit of PCM holding the call's number."""

    def __init__(self, device=None):
        self.n = 0

    def set_sound_system(self, ss):
        pass

    def set_binaural(self):
        pass

    def configure(self, data):
        return 0

    def decode(self, data):
        self.n += 1
        return 1, np.full((960, 2), self.n, np.int16)


def _stub_driver(n_bytes=1 << 22):
    stream = content.Stream(bytes(n_bytes), n_bytes, 960, 48000)
    d = drivers.Serial(_cfg(), {"mode": "serial"}, [stream], 1,
                       device="cpu")
    d.make = StubDecoder
    d.warm()
    return d


def _kept_calls(win):
    return win.outputs[::960, 0].tolist()


def test_driver_keeps_pcm_of_capped_calls(monkeypatch):
    monkeypatch.setattr(drivers, "CHECK_CALLS", 7)
    win = _stub_driver().run(0.05)
    assert win.attempted > drivers.WARM_UNITS + 7
    kept = drivers.WARM_UNITS + 7
    assert _kept_calls(win) == list(range(1, kept + 1))
    assert win.units == kept


def test_traced_serial_window_ends_at_check_calls(monkeypatch):
    monkeypatch.setattr(drivers, "CHECK_CALLS", 9)
    win = _stub_driver().run(60.0, traced=True)
    assert win.attempted == 9 == len(win.spans["decode_call"])
    assert win.seconds < 60.0
    assert win.units == drivers.WARM_UNITS + 9


def test_untraced_serial_window_ends_at_seconds(monkeypatch):
    monkeypatch.setattr(drivers, "CHECK_CALLS", 9)
    win = _stub_driver().run(0.1)
    assert win.seconds >= 0.1
    assert win.attempted > 9


def test_stream_ending_inside_the_window_raises():
    d = _stub_driver(n_bytes=50)
    with pytest.raises(RuntimeError, match="ended inside the window"):
        d.run(60.0)


@pytest.mark.parametrize("seconds,cap", [(0.0, 4000), (0.05, 5)])
def test_check_asks_reference_for_kept_units(monkeypatch, seconds, cap):
    monkeypatch.setattr(drivers, "CHECK_CALLS", cap)
    win = _stub_driver().run(seconds)
    asked = []

    def reference_pcm(cfg, stream, units=None, device="cuda", tf32=False,
                      root=None):
        asked.append(units)
        return np.zeros((units * 960, 2), np.int16)

    monkeypatch.setattr(check, "reference_pcm", reference_pcm)
    check.serial_numbers(_cfg(), {}, win, 1, "cpu")
    assert asked == [drivers.WARM_UNITS + min(win.attempted, cap) + 1]


_PARSE = entropy.parse


def _whole_parse(stream, units=None):
    """entropy.parse as it was: every OBU of the stream, its trims summed
    by iamf_bits.trims."""
    info = _PARSE(stream)
    info["lead"], info["tail"] = ib.trims(stream)
    return info


def test_serial_numbers_equal_todays_on_a_short_window(monkeypatch):
    """A real CPU window of fewer calls than the cap: the numbers equal
    those of the check before the cap (every kept sample against a
    reference of every unit returned, the stream parsed whole)."""
    cfg = _cfg()
    traffic = {"mode": "serial", "streams": 1, "units": 120}
    seed = 2**31 + 77
    stream = content.make(cfg, traffic, seed)[0]
    d = drivers.Serial(cfg, traffic, [stream], seed, device="cpu")
    d.warm()
    win = d.run(0.2)
    assert win.attempted < drivers.CHECK_CALLS
    got = check.serial_numbers(cfg, traffic, win, seed, "cpu")

    monkeypatch.setattr(entropy, "parse", _whole_parse)
    whole = content.Stream(stream.data, stream.units, stream.frame,
                           stream.rate, stage=stream.program_stage)
    want = check.reference_pcm(cfg, whole,
                               drivers.WARM_UNITS + win.attempted + 1,
                               device="cpu")
    today = check._numbers([check._gaps(win.outputs, want,
                                        len(want) - 960 - check.DELAY)])
    assert got == today
    assert got["samples"] == win.outputs.size
    assert got["max_gap_lsb"] <= cfg["limits"]["max_gap_lsb"]


@pytest.mark.parametrize("first,units", [(0, 3), (5, 20), (15, 17)])
def test_loop_trims_equal_trims(first, units):
    sample = _sample()
    data = ib.loop_units(sample, units, first)
    assert ib.loop_trims(sample) == ib.trims(data)
    assert ib.loop_trims(sample)[0] > 0  # the Opus pre-skip


@pytest.mark.parametrize("units", [1, 7, 30])
def test_parse_reads_only_its_units(monkeypatch, units):
    data = ib.loop_units(_sample(), 40, 3)
    whole = entropy.parse(data)
    assert (whole["lead"], whole["tail"]) == ib.trims(data)
    desc, src = ib.split_into_units(data)
    seen = []
    split = ib.split_obu

    def split_obu(buf, pos=0):
        seen.append(pos)
        return split(buf, pos)

    monkeypatch.setattr(ib, "split_obu", split_obu)
    part = entropy.parse(data, units)
    # the walk ends inside the descriptors and the first `units` units
    assert max(seen) < len(desc) + sum(len(u) for u in src[:units])
    assert {k: v for k, v in part.items() if k != "packets"} == {
        k: v for k, v in whole.items() if k != "packets"}
    assert part["packets"] == {s: p[:units]
                               for s, p in whole["packets"].items()}


def test_serial_stream_outlasts_a_fast_window():
    """The serial stream holds a whole window of calls down to a mean of
    0.3 ms after its warm-up, so a player some 60 times faster than the
    first port's still ends its window before the stream."""
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    serial = json.load(open(os.path.join(BENCH, "traffic", "serial.json")))
    assert (serial["units"] - drivers.WARM_UNITS
            >= bench["run_seconds"] / 0.3e-3)
