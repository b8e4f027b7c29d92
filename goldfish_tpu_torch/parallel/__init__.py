"""Multi-GPU execution: the patch split over torch.distributed ranks
(`parallel.sharding`)."""
