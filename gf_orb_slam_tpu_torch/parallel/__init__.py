"""Multi-device work: the keyframe-sharded distributed global bundle
adjustment on torch.distributed, and its process-group helpers."""
