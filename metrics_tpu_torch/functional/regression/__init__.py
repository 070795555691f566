from metrics_tpu_torch.functional.regression.concordance import concordance_corrcoef  # noqa: F401
from metrics_tpu_torch.functional.regression.cosine_similarity import cosine_similarity  # noqa: F401
from metrics_tpu_torch.functional.regression.explained_variance import explained_variance  # noqa: F401
from metrics_tpu_torch.functional.regression.kendall import kendall_rank_corrcoef  # noqa: F401
from metrics_tpu_torch.functional.regression.kl_divergence import kl_divergence  # noqa: F401
from metrics_tpu_torch.functional.regression.mape import (  # noqa: F401
    mean_absolute_percentage_error,
    symmetric_mean_absolute_percentage_error,
    weighted_mean_absolute_percentage_error,
)
from metrics_tpu_torch.functional.regression.mean_absolute_error import mean_absolute_error  # noqa: F401
from metrics_tpu_torch.functional.regression.mean_relative_error import mean_relative_error  # noqa: F401
from metrics_tpu_torch.functional.regression.mean_squared_error import mean_squared_error  # noqa: F401
from metrics_tpu_torch.functional.regression.mean_squared_log_error import mean_squared_log_error  # noqa: F401
from metrics_tpu_torch.functional.regression.minkowski import log_cosh_error, minkowski_distance  # noqa: F401
from metrics_tpu_torch.functional.regression.ms_ssim import multiscale_ssim  # noqa: F401
from metrics_tpu_torch.functional.regression.pearson import pearson_corrcoef  # noqa: F401
from metrics_tpu_torch.functional.regression.psnr import psnr  # noqa: F401
from metrics_tpu_torch.functional.regression.r2score import r2score  # noqa: F401
from metrics_tpu_torch.functional.regression.spearman import spearman_corrcoef  # noqa: F401
from metrics_tpu_torch.functional.regression.spectral import (  # noqa: F401
    error_relative_global_dimensionless_synthesis,
    spectral_angle_mapper,
)
from metrics_tpu_torch.functional.regression.ssim import ssim  # noqa: F401
from metrics_tpu_torch.functional.regression.total_variation import total_variation  # noqa: F401
from metrics_tpu_torch.functional.regression.tweedie import tweedie_deviance_score  # noqa: F401
from metrics_tpu_torch.functional.regression.uqi import universal_image_quality_index  # noqa: F401
