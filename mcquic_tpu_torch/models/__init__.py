from mcquic_tpu_torch.models.compressor import Compressor

__all__ = ["Compressor"]
