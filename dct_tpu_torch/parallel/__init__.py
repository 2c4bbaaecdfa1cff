"""Sharded encode and decode over torch.distributed (port of
``dct_tpu.parallel``): mesh.py builds the (data, stripe) mesh;
shard_encode.py holds the two collective calls, the mesh's placement
(MeshPlacement: each rank's band of frames and stripes, the masked
histograms, the gathers) that the codec's own plans run over, and the
public sharded entry points."""
