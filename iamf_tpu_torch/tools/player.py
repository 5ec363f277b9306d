"""CLI player mirroring the reference iamfplayer (test/tools/iamfplayer/
player/iamfplayer.c:791-926): a copy of iamf_tpu/tools/player.py on this
package's frame-serial decoder (api.py), with one option more, --device
(default cuda: the card; cpu: the kernels' plain twins).

    python -m iamf_tpu_torch.tools.player -o2 -s9 [--device cpu] file.iamf

Flags: -i0/-i1 input mode (bitstream/mp4), -o0/-o2 output (none/wav),
-s<N>|-sb sound system / binaural, -r <rate>, -ts <sec> (mp4 seek),
-p <db> peak threshold, -l <db> normalization loudness, -d <bits> depth,
-mp <id> mix presentation id, -m metadata sidecar, -disable_limiter,
--device cuda|cpu.
Output naming: ss<N>_<input>.wav / binaural_<input>.wav (iamfplayer.c:323).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..api import IAMFDecoder, InvalidState, IAMFError
from ..utils.wav import write_wav

BLOCK_SIZE = 960 * 6 * 2 * 16  # iamfplayer.c:372


def decode_bitstream(dec: IAMFDecoder, path: str):
    """bs_input_wav_output loop (iamfplayer.c:529-662)."""
    with open(path, "rb") as f:
        data = f.read()

    pos = 0
    # configure until OK
    consumed = dec.configure(data[pos:])
    pos += consumed

    chunks = []
    frames = 0
    t0 = time.perf_counter()
    while pos < len(data):
        try:
            consumed, pcm = dec.decode(data[pos:])
        except InvalidState:
            consumed = dec.configure(data[pos:])
            pos += consumed
            continue
        if consumed == 0 and pcm is None:
            break
        pos += consumed
        if pcm is not None and len(pcm):
            chunks.append(pcm)
            frames += 1
    # flush
    _, pcm = dec.decode(None)
    if pcm is not None and len(pcm):
        chunks.append(pcm)
    elapsed = time.perf_counter() - t0

    if chunks:
        out = np.concatenate(chunks, axis=0)
    else:
        out = np.zeros((0, dec.layout.channels), dtype=np.int32)
    return out, frames, elapsed


def decode_mp4(dec: IAMFDecoder, path: str, start_sec: float = 0.0):
    """mp4_input_wav_output2 loop (iamfplayer.c:664-789)."""
    from ..mp4.iamf_track import MP4IAMFParser

    mp4 = MP4IAMFParser(path)
    if start_sec > 0:
        mp4.seek(start_sec)
    dec.set_pts(-int(mp4.skip_samples * 90000 / mp4.timescale), 90000)
    dec.configure(mp4.descriptors)
    chunks = []
    frames = 0
    t0 = time.perf_counter()
    for packet, new_descriptors in mp4.packets():
        if new_descriptors:
            dec.configure(new_descriptors)
        data = packet
        while data:
            consumed, pcm = dec.decode(data)
            if pcm is not None and len(pcm):
                chunks.append(pcm)
                frames += 1
            if consumed == 0:
                break
            data = data[consumed:]
    _, pcm = dec.decode(None)
    if pcm is not None and len(pcm):
        chunks.append(pcm)
    elapsed = time.perf_counter() - t0
    out = (
        np.concatenate(chunks, axis=0)
        if chunks
        else np.zeros((0, dec.layout.channels), dtype=np.int32)
    )
    return out, frames, elapsed


def soak_sound_systems(args) -> int:
    """Randomized layout-switch soak (the reference's -test_soundsystem,
    player_test_sound_system iamfplayer.c:453-519): decode the stream while
    re-targeting a random sound system / binaural every interval via
    configure(None) reconfigure with stream reuse; one wav per segment."""
    import random

    from ..constants import SoundSystem

    rng = random.Random(args.test_soundsystem)
    dec = IAMFDecoder(device=args.device)
    dec.samsung_tv = args.tv
    dec.set_sound_system(0)
    with open(args.input, "rb") as f:
        data = f.read()
    pos = dec.configure(data)
    valid = [s.value for s in SoundSystem] + ["b"]
    segments = []
    chunks = []
    frames = 0
    cur = 0  # int, matching SoundSystem values (plus the "b" binaural pick)
    interval = 25  # ~0.5 s of 960-sample frames
    while pos < len(data):
        if frames and frames % interval == 0:
            if chunks:
                segments.append((cur, np.concatenate(chunks, axis=0)))
                chunks = []
            nxt = cur
            while nxt == cur:
                nxt = rng.choice(valid)
            cur = nxt
            if cur == "b":
                dec.set_binaural()
            else:
                dec.set_sound_system(int(cur))
            dec.configure(None)
            print(f"Change to {cur} and it has {dec.layout.channels} "
                  f"channels")
        consumed, pcm = dec.decode(data[pos:])
        if consumed == 0 and pcm is None:
            break
        pos += consumed
        if pcm is not None and len(pcm):
            chunks.append(pcm)
            frames += 1
    _, pcm = dec.decode(None)
    if pcm is not None and len(pcm):
        chunks.append(pcm)
    if chunks:
        segments.append((cur, np.concatenate(chunks, axis=0)))
    base = os.path.basename(args.input).rsplit(".", 1)[0]
    for i, (name, seg) in enumerate(segments):
        prefix = "binaural" if name == "b" else f"ss{name}"
        write_wav(f"{prefix}_{i}_{base}.wav", seg, args.r, args.d)
    print(f"Get {frames} frames over {len(segments)} layout segments")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="iamfplayer", description=__doc__)
    ap.add_argument("input")
    ap.add_argument("-i", type=int, default=0, help="0: bitstream, 1: mp4")
    ap.add_argument("-o", type=int, default=2, help="0: none, 2: wav")
    ap.add_argument("-s", default="0", help="sound system 0..12 or 'b'")
    ap.add_argument("-r", type=int, default=48000, help="output sample rate")
    ap.add_argument("-ts", type=float, default=0.0, help="start time (mp4)")
    ap.add_argument("-p", type=float, default=None, help="peak threshold dB")
    ap.add_argument("-l", type=float, default=None, help="loudness norm dB")
    ap.add_argument("-d", type=int, default=16, help="bit depth")
    ap.add_argument("-mp", type=int, default=None, help="mix presentation id")
    ap.add_argument("-m", action="store_true", help="write .met sidecar")
    ap.add_argument("-disable_limiter", action="store_true")
    ap.add_argument("-tv", action="store_true", help="SAMSUNG_TV compat mode")
    ap.add_argument("-v", metavar="FILE", default=None,
                    help="write OBU vlog (SUPPORT_VERIFIER vlogging)")
    ap.add_argument("-sr", metavar="DIR", default=None,
                    help="dump per-stage wavs (IAMF_debug_sr taps)")
    ap.add_argument("-test_soundsystem", type=int, default=None,
                    metavar="SEED",
                    help="randomized layout-switch soak: reconfigure the "
                         "output layout every ~0.5 s mid-stream "
                         "(player_test_sound_system, iamfplayer.c:453-519)")
    ap.add_argument("--device", default="cuda",
                    help="decode device: cuda (default, the card) or cpu")
    args = ap.parse_args(argv)

    if args.test_soundsystem is not None:
        return soak_sound_systems(args)

    dec = IAMFDecoder(device=args.device)
    dec.samsung_tv = args.tv
    if args.s == "b":
        dec.set_binaural()
        prefix = "binaural"
    else:
        dec.set_sound_system(int(args.s))
        prefix = f"ss{args.s}"
    dec.set_sampling_rate(args.r)
    dec.set_bit_depth(args.d)
    if args.p is not None:
        dec.set_peak_limiter_threshold(args.p)
    if args.l is not None:
        dec.set_normalization_loudness(args.l)
    if args.mp is not None:
        dec.set_mix_presentation_id(args.mp)
    if args.disable_limiter:
        dec.set_peak_limiter_enable(False)
    if args.sr is not None:
        dec.stream_log = True

    if args.v is not None:
        with open(args.input, "rb") as f:
            raw = f.read()
        if args.i == 1:
            # mp4 input: box-level YAML log, then the OBU log over the
            # descriptors AND every packet's OBUs — the reference verifier
            # logs both streams into one file, mp4 boxes first
            # (vlogging_iamfmp4_sr.c + vlogging_tool_sr.c, print order
            # LOG_MP4BOX before LOG_OBU, vlogging_tool_sr.c:115)
            from ..mp4.atoms import vlog_mp4
            from ..mp4.iamf_track import MP4IAMFParser
            from ..obu import parser as obu_parser
            from .vlogger import VLogger

            mp4 = MP4IAMFParser(args.input)
            with open(args.v, "w") as out:
                # whole-file box walk first, OBU logs after: the reference
                # verifier's open-time parse walks every box — including
                # ALL moofs of a fragmented file — before the decoder sees
                # the descriptors (mp4demux.c open parse; verified against
                # the verifier build on fMP4 content in test_vlogger_diff)
                n = vlog_mp4(raw, out)
                v = VLogger(out)
                for obu in obu_parser.iter_obus(
                        memoryview(mp4.descriptors)):
                    v.log_obu(obu)
                for packet, new_desc in mp4.packets():
                    if new_desc:
                        # sample-description change: the re-glued
                        # descriptor OBUs log in stream order, as the
                        # reference verifier does
                        for obu in obu_parser.iter_obus(
                                memoryview(new_desc)):
                            v.log_obu(obu)
                    for obu in obu_parser.iter_obus(memoryview(packet)):
                        v.log_obu(obu)
                n += v._count
            print(f"vlogged {n} mp4 boxes + OBUs -> {args.v}")
        else:
            from .vlogger import vlog_stream

            with open(args.v, "w") as out:
                n = vlog_stream(raw, out)
            print(f"vlogged {n} OBUs -> {args.v}")

    try:
        if args.i == 1:
            pcm, frames, elapsed = decode_mp4(dec, args.input, args.ts)
        else:
            pcm, frames, elapsed = decode_bitstream(dec, args.input)
    except IAMFError as e:
        print(f"decode failed: {e}", file=sys.stderr)
        return 1

    samples = len(pcm)
    dur = samples / args.r if args.r else 0.0
    rtx = dur / elapsed if elapsed > 0 else float("inf")
    print(f"Get {frames} frames, {samples} samples")
    print(f"decode time {elapsed:.3f}s, realtime x{rtx:.1f}")

    if args.o == 2:
        base = os.path.basename(args.input)
        stem = base.rsplit(".", 1)[0]
        out_path = f"{prefix}_{stem}.wav"
        write_wav(out_path, pcm, args.r, args.d)
        print(f"wrote {out_path}")

    if args.sr is not None:
        files = dec.write_stream_logs(args.sr)
        print(f"wrote {len(files)} stage wavs -> {args.sr}")

    if args.m:
        md = dec.get_last_metadata()
        with open(f"{args.input}.met", "w") as f:
            f.write(
                f"sound_system={md.output_sound_system} bitdepth={md.bitdepth} "
                f"rate={md.sampling_rate} dmixp_mode={md.dmixp_mode}\n"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
