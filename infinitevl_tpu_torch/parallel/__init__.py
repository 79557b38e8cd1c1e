"""Multi-process training over torch.distributed (torch port of the data axis
of infinitevl_tpu/parallel/)."""
