"""Sharded encode and decode over torch.distributed (port of
``dct_tpu.parallel``): mesh.py builds the (data, stripe) mesh,
shard_encode.py runs the codec on each rank's band of frames and stripes."""
