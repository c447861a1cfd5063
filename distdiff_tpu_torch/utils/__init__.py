from distdiff_tpu_torch.utils import classnames, profiling, prompts, visualize
from distdiff_tpu_torch.utils.logger import Logger, LoggerMonitor
from distdiff_tpu_torch.utils.meters import AverageMeter, Stopwatch
from distdiff_tpu_torch.utils.metrics import accuracy

__all__ = ["Logger", "LoggerMonitor", "AverageMeter", "Stopwatch", "accuracy", "classnames",
           "profiling", "prompts", "visualize"]
