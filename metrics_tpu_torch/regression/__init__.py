from metrics_tpu_torch.regression.concordance import ConcordanceCorrCoef  # noqa: F401
from metrics_tpu_torch.regression.cosine_similarity import CosineSimilarity  # noqa: F401
from metrics_tpu_torch.regression.explained_variance import ExplainedVariance  # noqa: F401
from metrics_tpu_torch.regression.kendall import KendallRankCorrCoef  # noqa: F401
from metrics_tpu_torch.regression.kl_divergence import KLDivergence  # noqa: F401
from metrics_tpu_torch.regression.mape import (  # noqa: F401
    MeanAbsolutePercentageError,
    SymmetricMeanAbsolutePercentageError,
    WeightedMeanAbsolutePercentageError,
)
from metrics_tpu_torch.regression.mean_absolute_error import MeanAbsoluteError  # noqa: F401
from metrics_tpu_torch.regression.mean_squared_error import MeanSquaredError  # noqa: F401
from metrics_tpu_torch.regression.mean_squared_log_error import MeanSquaredLogError  # noqa: F401
from metrics_tpu_torch.regression.median_absolute_error import MedianAbsoluteError  # noqa: F401
from metrics_tpu_torch.regression.minkowski import LogCoshError, MinkowskiDistance  # noqa: F401
from metrics_tpu_torch.regression.ms_ssim import MultiScaleSSIM  # noqa: F401
from metrics_tpu_torch.regression.pearson import PearsonCorrcoef  # noqa: F401
from metrics_tpu_torch.regression.psnr import PSNR  # noqa: F401
from metrics_tpu_torch.regression.quantile import Percentile, Quantile  # noqa: F401
from metrics_tpu_torch.regression.r2score import R2Score  # noqa: F401
from metrics_tpu_torch.regression.relative_squared import RelativeSquaredError  # noqa: F401
from metrics_tpu_torch.regression.spearman import SpearmanCorrcoef  # noqa: F401
from metrics_tpu_torch.regression.spectral import (  # noqa: F401
    ErrorRelativeGlobalDimensionlessSynthesis,
    SpectralAngleMapper,
)
from metrics_tpu_torch.regression.ssim import SSIM  # noqa: F401
from metrics_tpu_torch.regression.total_variation import TotalVariation  # noqa: F401
from metrics_tpu_torch.regression.tweedie import TweedieDevianceScore  # noqa: F401
from metrics_tpu_torch.regression.uqi import UniversalImageQualityIndex  # noqa: F401
