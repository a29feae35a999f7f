"""Tasks, losses and metrics of the port."""

from hyena_dna_tpu_torch.tasks.tasks import HG38Task, LMTask

__all__ = ["LMTask", "HG38Task"]
