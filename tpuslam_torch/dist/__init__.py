"""Multi-device layer of the port: mesh (torch.distributed), the ring-sharded
frame-to-map ICP and the all-to-all sharded voxel-map fusion."""
