"""Audio metrics: SNR, SI_SDR, SI_SNR, PIT. Counterpart of ``metrics_tpu/audio/``."""
from metrics_tpu_torch.audio.pit import PIT
from metrics_tpu_torch.audio.si_sdr import SI_SDR, SI_SNR
from metrics_tpu_torch.audio.snr import SNR

__all__ = ["SNR", "SI_SDR", "SI_SNR", "PIT"]
