from repro_torch.core.scheduler.darp import DarpScheduler, SchedulerPolicy

__all__ = ["DarpScheduler", "SchedulerPolicy"]
