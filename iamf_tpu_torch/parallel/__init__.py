"""Multi-device decode: the frame-sharded ShardedStreamDecoder over a
ShardMesh (one process or several, torch.distributed) and the two-stage
PipelinedStreamDecoder (counterpart of iamf_tpu/parallel/)."""
