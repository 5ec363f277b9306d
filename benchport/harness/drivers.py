"""The timed paths: what a traffic file's ``mode`` drives.

- ``fleet``: a transcoding fleet, closed loop, fleets back to back. Each
  fleet is a new ``MultiStreamServer(streams, device="cuda", **decoder)``
  (the front end: OBU parse and timeline replay), then ``decode_all()``
  (the host plans and the device decode), then every stream's PCM fetched
  to the host, as a transcoder writes it. The window closes when the
  fleet running at ``seconds`` completes.
- ``sharded``: one long stream wanted back fast, closed loop: a new
  ``ShardedStreamDecoder(stream, n_devices=devices, ...)`` (the frames
  mesh over the cards of one process), then ``decode_all()`` (host PCM),
  back to back until ``seconds``.
- ``serial``: the frame-serial player. One ``IAMFDecoder`` configured on
  the stream, warmed by its first ``WARM_UNITS`` calls, then one temporal
  unit a ``decode()`` call, each call timed to its host PCM, closed loop,
  until ``seconds``; a traced window (``traced``) closes after
  ``CHECK_CALLS`` calls if that comes first, so its trace stays bounded
  however fast the calls get. The PCM of the warm-up and of the window's
  first ``CHECK_CALLS`` calls is kept for the check, so that neither what
  is kept nor the reference's work grows with the calls a window makes.

Each returns a Window: its host spans by name, the audio seconds and the
requests completed, and what the correctness check compares.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

# a fleet: the check compares one of the window's first KEEP_WITHIN
# fleets, drawn from the seed
KEEP_WITHIN = 4
# the serial player: decode() calls that warm the decoder up in set-up
WARM_UNITS = 32
# the serial player: the window's calls whose PCM the check compares, and
# the most calls a traced window makes (above the 3,239 that a 51 s window
# of the first port's 16-20 ms calls held)
CHECK_CALLS = 4000


class Window:
    def __init__(self):
        self.spans: dict = {"constructor": [], "serve": [], "fetch": [],
                            "decode_call": [], "shard_construct": []}
        self.audio_s = 0.0
        self.seconds = 0.0
        self.attempted = 0
        self.failed = 0
        self.streams_done: list = []  # Stream objects, once per completion
        self.fleet_streams: list = []  # the generated streams, in order
        self.units = 0  # the serial calls' temporal units
        self.outputs = None  # what check.py compares


def _sync(device: str) -> None:
    if device == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


class Fleet:
    def __init__(self, cfg: dict, traffic: dict, streams: list, seed: int,
                 device: str = "cuda"):
        from iamf_tpu_torch.core.serving import MultiStreamServer

        self.device = device
        self.server = MultiStreamServer
        self.kw = dict(cfg["decoder"])
        self.streams = streams
        self.data = [s.data for s in streams]
        self.keep = seed % KEEP_WITHIN

    def _serve(self, win: Window | None):
        t0 = time.perf_counter()
        with record_function("constructor"):
            srv = self.server(self.data, device=self.device, **self.kw)
        t1 = time.perf_counter()
        with record_function("serve"):
            outs = srv.decode_all()
        t2 = time.perf_counter()
        with record_function("fetch"):
            host = [torch.cat(o).cpu().numpy() if o else None for o in outs]
        t3 = time.perf_counter()
        del srv, outs
        if win is not None:
            win.spans["constructor"].append((t0, t1))
            win.spans["serve"].append((t1, t2))
            win.spans["fetch"].append((t2, t3))
        return host

    def warm(self) -> None:
        self._serve(None)
        _sync(self.device)

    def run(self, seconds: float, traced: bool = False) -> Window:
        win = Window()
        win.fleet_streams = self.streams
        start = time.perf_counter()
        fleets = 0
        while True:
            host = self._serve(win)
            end = time.perf_counter()
            for s, h in zip(self.streams, host):
                win.attempted += 1
                if h is None:
                    win.failed += 1
                else:
                    win.audio_s += s.seconds
                    win.streams_done.append(s)
            if fleets == self.keep:
                win.outputs = host
            fleets += 1
            if end - start >= seconds:
                break
        win.seconds = end - start
        if win.outputs is None:  # fewer fleets than the kept one's index
            win.outputs = host
        return win


class Sharded:
    def __init__(self, cfg: dict, traffic: dict, streams: list, seed: int,
                 device: str = "cuda"):
        from iamf_tpu_torch.parallel.sharded_decoder import \
            ShardedStreamDecoder

        self.device = device
        self.make = ShardedStreamDecoder
        self.kw = dict(n_devices=traffic["devices"],
                       sound_system=cfg["decoder"]["sound_system"])
        self.stream = streams[0]

    def _decode(self, win: Window | None):
        t0 = time.perf_counter()
        with record_function("shard_construct"):
            dec = self.make(self.stream.data, device=self.device, **self.kw)
        t1 = time.perf_counter()
        with record_function("serve"):
            pcm = dec.decode_all()
        t2 = time.perf_counter()
        if win is not None:
            win.spans["shard_construct"].append((t0, t1))
            win.spans["serve"].append((t1, t2))
        return pcm

    def warm(self) -> None:
        self._decode(None)
        _sync(self.device)

    def run(self, seconds: float, traced: bool = False) -> Window:
        win = Window()
        win.fleet_streams = [self.stream]
        start = time.perf_counter()
        while True:
            pcm = self._decode(win)
            end = time.perf_counter()
            win.attempted += 1
            win.audio_s += self.stream.seconds
            win.streams_done.append(self.stream)
            if win.outputs is None:
                win.outputs = [pcm]
            if end - start >= seconds:
                break
        win.seconds = end - start
        return win


class Serial:
    def __init__(self, cfg: dict, traffic: dict, streams: list, seed: int,
                 device: str = "cuda"):
        from iamf_tpu_torch.api import IAMFDecoder

        self.device = device
        self.make = IAMFDecoder
        self.cfg = cfg
        self.stream = streams[0]

    def warm(self) -> None:
        """Configure the one decoder on the stream and make its first
        WARM_UNITS calls; their PCM stays for the check."""
        dec = self.make(device=self.device)
        if self.cfg.get("binaural"):
            dec.set_binaural()
        else:
            dec.set_sound_system(self.cfg["decoder"]["sound_system"])
        data = memoryview(self.stream.data)
        pos = dec.configure(data)
        self.warm_pcm = []
        for _ in range(WARM_UNITS):
            consumed, pcm = dec.decode(data[pos:])
            pos += consumed
            if pcm is not None and len(pcm):
                self.warm_pcm.append(pcm)
        _sync(self.device)
        self.dec, self.data, self.pos = dec, data, pos

    def run(self, seconds: float, traced: bool = False) -> Window:
        win = Window()
        win.fleet_streams = [self.stream]
        dec, data, pos = self.dec, self.data, self.pos
        chunks = list(self.warm_pcm)
        calls = win.spans["decode_call"]
        last = CHECK_CALLS if traced else None
        start = time.perf_counter()
        while pos < len(data):
            t0 = time.perf_counter()
            with record_function("decode_call"):
                consumed, pcm = dec.decode(data[pos:])
            t1 = time.perf_counter()
            calls.append((t0, t1))
            win.attempted += 1
            if consumed == 0:
                win.failed += 1
                break
            pos += consumed
            if pcm is not None and len(pcm) and win.attempted <= CHECK_CALLS:
                chunks.append(pcm)
            if t1 - start >= seconds or win.attempted == last:
                break
        else:
            raise RuntimeError("the serial stream ended inside the window: "
                               "give the traffic more units")
        win.seconds = t1 - start
        win.audio_s = win.attempted * self.stream.frame / self.stream.rate
        win.outputs = np.concatenate(chunks) if chunks else None
        # the units whose PCM the outputs hold: the warm-up's and the
        # window's first CHECK_CALLS
        win.units = WARM_UNITS + min(win.attempted, CHECK_CALLS)
        self.dec = None
        return win


MODES = {"fleet": Fleet, "serial": Serial, "sharded": Sharded}
