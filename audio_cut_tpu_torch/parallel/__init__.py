"""Scale-out over the CUDA devices: the device mesh and the batch's separation."""
