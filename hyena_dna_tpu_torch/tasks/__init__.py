"""Tasks, losses and metrics of the port."""

from hyena_dna_tpu_torch.tasks.tasks import (TASK_REGISTRY, BaseTask, HG38Task, ICLTask, LMTask,
                                             MulticlassTask)

__all__ = ["BaseTask", "LMTask", "HG38Task", "ICLTask", "MulticlassTask", "TASK_REGISTRY"]
