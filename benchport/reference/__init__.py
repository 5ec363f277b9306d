"""Plain references of the benchmark's configurations: NumPy, SciPy and
plain PyTorch only; nothing of the program under test.

A configuration's ``"reference"`` names ``benchport/reference/<name>.py``,
which defines ``pcm(cfg, stream, units, device, tf32)``: the s16 output
[samples, channels] of one generated stream (of its first `units` temporal
units where the check asks for fewer than all). It may define
``numbers(cfg, stage, tf32)``: further compared numbers, whose limits are
in the configuration's ``limits``; ``stage`` is the content kind's
``stage`` (None where it has none).

The limiter's delay line and its times are at RATE Hz.
"""

DELAY = 240
RATE = 48000
