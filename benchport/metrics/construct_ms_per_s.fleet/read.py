"""construct_ms_per_s.fleet: host milliseconds inside
MultiStreamServer(...) (OBU parse and timeline replay of every stream) a
second of audio completed (host clock around the benchmark's call)."""


def read(run):
    spans = run.win.spans["constructor"]
    if not spans or run.win.audio_s <= 0:
        return None
    return sum(b - a for a, b in spans) * 1e3 / run.win.audio_s
