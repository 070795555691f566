from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training, pit_permutate  # noqa: F401
from metrics_tpu_torch.functional.audio.si_sdr import (  # noqa: F401
    scale_invariant_signal_distortion_ratio,
    scale_invariant_signal_noise_ratio,
)
from metrics_tpu_torch.functional.audio.snr import signal_noise_ratio  # noqa: F401

__all__ = [
    "permutation_invariant_training",
    "pit_permutate",
    "signal_noise_ratio",
    "scale_invariant_signal_distortion_ratio",
    "scale_invariant_signal_noise_ratio",
]
