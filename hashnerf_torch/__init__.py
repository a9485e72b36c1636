"""hashnerf_torch — the PyTorch / CUDA (NVIDIA Hopper) port of hashnerf_tpu.

The package mirrors hashnerf_tpu's layout (ops/, kernels/, models/, render/,
train/, data/, utils/) so each module has an obvious counterpart, and it
imports neither jax nor hashnerf_tpu: it runs alone on a GPU host. The JAX
package stays the reference; tests/test_torch_*.py hold each port module
against its JAX counterpart on the CPU.

Precision: the JAX package runs every MLP matmul and einsum at
Precision.HIGHEST (full float32). The port therefore turns TF32 off for both
cuBLAS matmuls and cuDNN convolutions, so float32 products stay float32 on
the card.
"""
import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no device named and no GPU present this raises rather than
    carrying on on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "hashnerf_torch: no CUDA device is available; pass device='cpu' "
            "(or --device cpu) to run on the CPU"
        )
    return torch.device("cuda")
