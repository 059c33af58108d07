"""Multi-device layer of the port: the mesh (torch.distributed), the
point-sharded ICP, the ring-sharded frame-to-map ICP, the all-to-all
sharded voxel-map fusion and the data-parallel batched alignment."""
