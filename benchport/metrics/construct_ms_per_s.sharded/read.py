"""construct_ms_per_s.sharded: host milliseconds inside
ShardedStreamDecoder(...) (OBU parse and timeline replay of the stream) a
second of audio completed (host clock around the benchmark's call)."""


def read(run):
    spans = run.win.spans["shard_construct"]
    if not spans or run.win.audio_s <= 0:
        return None
    return sum(b - a for a, b in spans) * 1e3 / run.win.audio_s
