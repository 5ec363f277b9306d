"""mesh_ms_per_s.sharded: host milliseconds inside the program's mesh.hop
spans, every ShardMesh exchange (ppermute, psum, all_gather,
process_allgather), a second of audio completed in the window (program spans
on the host clock)."""

from harness import spans


def read(run):
    return spans.ms_per_s(run, "mesh.hop")
