from visiondk_tpu_torch.utils.logger import SmartLogger
from visiondk_tpu_torch.utils.meters import AverageMeter
from visiondk_tpu_torch.utils.metrics_writer import MetricsWriter
from visiondk_tpu_torch.utils.plots import colorstr, plot_confusion_matrix

__all__ = ["SmartLogger", "AverageMeter", "MetricsWriter", "colorstr", "plot_confusion_matrix"]
