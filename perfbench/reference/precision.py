"""The arithmetic the plain reference computes in.

`EXACT` is float32 with TF32 off: the reference itself. `FP8` rounds every
operand of a matrix product (each weight and each activation, per tensor
scaled to e4m3's range) to float8 e4m3 before a float32 product: the control,
one step below the bfloat16 the configurations state (a backward pass takes
the rounding's gradient as the identity, so its products see the rounded
operands). `TF32` leaves the operands as they are and lets the product run in
TF32: the control of the codebook search, which the configurations state in
float32.
"""

import contextlib

import torch

E4M3_MAX = 448.0


class Precision:
    def __init__(self, name: str, fp8: bool = False, tf32: bool = False):
        self.name, self.fp8, self.tf32 = name, fp8, tf32

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, rounded as this precision rounds it (float32)."""
        x = x.float()
        if not self.fp8:
            return x
        scale = x.abs().amax().detach().clamp_min(1e-30) / E4M3_MAX
        xq = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (xq - x.detach())  # the rounded value, the gradient straight through

    @contextlib.contextmanager
    def matmul_mode(self):
        """TF32 on for this precision's products, off otherwise; restored after."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


EXACT = Precision("float32")
FP8 = Precision("fp8_e4m3", fp8=True)
TF32 = Precision("tf32", tf32=True)
