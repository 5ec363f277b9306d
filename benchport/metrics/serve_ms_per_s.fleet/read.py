"""serve_ms_per_s.fleet: host milliseconds inside decode_all() and the
fetch of the fleet's PCM to the host, a second of audio completed (host
clock around the benchmark's calls)."""


def read(run):
    spans = run.win.spans["serve"] + run.win.spans["fetch"]
    if not spans or run.win.audio_s <= 0:
        return None
    return sum(b - a for a, b in spans) * 1e3 / run.win.audio_s
