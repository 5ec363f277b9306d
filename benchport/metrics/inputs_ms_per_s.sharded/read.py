"""inputs_ms_per_s.sharded: host milliseconds inside the program's mesh.inputs
spans, ShardedStreamDecoder._host_inputs (the whole stream's host entropy
and unpack), a second of audio completed in the window (program spans on the
host clock)."""

from harness import spans


def read(run):
    return spans.ms_per_s(run, "mesh.inputs")
