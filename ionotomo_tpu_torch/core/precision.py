"""The full-f32 contract of every einsum/matmul in the port.

The reference pins ``Precision.HIGHEST`` because a reduced-precision
matmul pass broke its f32 error budget (core/boxspline.py in the JAX
package). On the card the counterpart hazard is TF32, which keeps about
three decimal digits.
"""
import torch


def check_full_f32() -> None:
    """Raise unless float32 matmuls and convolutions run in full f32."""
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError(
            "TF32 is enabled; the engine's f32 contract needs "
            "torch.backends.cuda.matmul.allow_tf32 = False, "
            "torch.backends.cudnn.allow_tf32 = False and float32 matmul "
            "precision 'highest'")
