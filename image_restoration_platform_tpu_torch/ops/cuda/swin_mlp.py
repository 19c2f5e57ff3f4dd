"""The Swin transformer's MLP, ``GELU(x W1 + b1) W2 + b2`` in one pass over
the tokens: the hand-written Hopper kernel and its plain version.

Ports no TPU kernel: the JAX package has no transformer. A Swin layer of
SwinIR (models/swinir.py:Mlp) runs fc1, the erf form of GELU and fc2 on its
normalised tokens; the kernel (csrc/swin_mlp.cu) does the three at once,
the hidden tensor held on the SM: f32 products, the biases added in f32, the
hidden value rounded to bf16 once as fc2's operand, m rounded to bf16.

``swin_mlp`` takes the kernel for CUDA tensors and the plain version for CPU
tensors; there is no other branch and no fallback between them. The kernel
reads its weights in the layout ``pack_weights`` lays out, once a weight
set: a module keeps its layout in a ``PackedWeights`` and lays it out again
only when a weight is replaced or written. ``check_shapes`` states what the
kernel takes; the engine calls it when it loads a SwinIR family
(``models.swinir.check_kernel_shapes``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

SOURCE = "swin_mlp.cu"
KERNEL_MAX_CHANNELS = 184  # fc2's width in the kernel
KERNEL_DEPTH = 192  # fc1's depth: three swizzle rows of 64 bf16
KERNEL_SLICE = 64  # hidden columns a slice
KERNEL_SLICES = 6
KERNEL_MAX_HIDDEN = KERNEL_SLICE * KERNEL_SLICES
UNIT_ROWS = 128  # tokens a unit of the persistent grid
SWIZZLE_ROW = 64  # bf16 values of one 128-byte swizzle row


def check_shapes(channels: int, hidden: int) -> None:
    """Raise unless the kernel takes tokens of ``channels`` channels and a
    hidden width of ``hidden``."""
    if channels % 4 or not 4 <= channels <= KERNEL_MAX_CHANNELS:
        raise ValueError(f"the MLP kernel takes a multiple of 4 channels up to {KERNEL_MAX_CHANNELS}, got {channels}")
    if not 1 <= hidden <= KERNEL_MAX_HIDDEN:
        raise ValueError(f"the MLP kernel takes a hidden width of 1 to {KERNEL_MAX_HIDDEN}, got {hidden}")


# ----------------------------------------------------------- plain version


def swin_mlp_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor) -> torch.Tensor:
    """Plain: the kernel's arithmetic, f32 products of the inputs' values,
    the biases in f32, GELU in f32, the hidden value rounded once to x's
    type and m rounded to it. In f32 it is ``F.linear(F.gelu(F.linear(x,
    w1.t(), b1)), w2.t(), b2)``, operation for operation."""
    h = F.gelu(F.linear(x.float(), w1.float().t(), b1.float())).to(x.dtype)
    return F.linear(h.float(), w2.float().t(), b2.float()).to(x.dtype)


def parity_bar(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
               chain: bool = False) -> torch.Tensor:
    """|kernel - other| allowed per element of m, where the other is the
    plain version (``chain`` False) or the chain of fc1, GELU and fc2 in
    bf16. Both round each hidden value h = GELU(p) from f32 sums taken in
    another order than the kernel's, so the two h may land one bf16 ulp
    apart (at most 2^-7 |h|); the chain also rounds p before GELU, at most
    2^-8 |p|, which GELU's slope (below 1.13) carries into h. Those carried
    through |w2|, plus one bf16 ulp of m and f32 round-off."""
    p = F.linear(x.float(), w1.float().t(), b1.float())
    h = F.gelu(p)
    apart = 2.0**-7 * h.abs() + (1.13 * 2.0**-8 * p.abs() if chain else 0.0)
    m = F.linear(h, w2.float().t(), b2.float())
    ulp = torch.exp2(torch.floor(torch.log2(m.abs().clamp_min(2.0**-30))) - 7)
    return ulp + apart @ w2.float().abs() + 1e-5 * (m.abs() + 1.0)


# ------------------------------------------------------------------ kernel


def swizzle_rows(t: torch.Tensor) -> torch.Tensor:
    """[..., R, 64] two-byte values in the 128-byte swizzle: the 8-value
    chunk j of row r moves to chunk j ^ (r % 8)."""
    rows = torch.arange(t.shape[-2], device=t.device)[:, None]
    chunks = torch.arange(8, device=t.device)[None, :] ^ (rows % 8)  # the chunk that lands at each place
    return t.reshape(*t.shape[:-1], 8, 8)[..., rows, chunks, :].reshape(t.shape)


def pack_weights(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's weights from w1 [C, H], b1 [H], w2 [H, C], b2 [C]:
    (wpack bf16 [6, 24064], bias f32 [568]). Slice s of wpack is W1's
    columns 64s .. 64s + 63 as 64 rows of the 192 padded input channels, in
    three 64-channel blocks, then W2's rows 64s .. as 184 rows of the 64
    hidden inputs of each padded output channel, every row swizzled; bias is
    b1 padded to 384, then b2 padded to 184. Zeros everywhere else."""
    c, hidden = w1.shape
    check_shapes(c, hidden)
    dev, bf16 = w1.device, torch.bfloat16
    w1t = torch.zeros((KERNEL_MAX_HIDDEN, KERNEL_DEPTH), dtype=bf16, device=dev)
    w1t[:hidden, :c] = w1.t()
    w2t = torch.zeros((KERNEL_MAX_CHANNELS, KERNEL_MAX_HIDDEN), dtype=bf16, device=dev)
    w2t[:c, :hidden] = w2.t()
    blocks = KERNEL_DEPTH // SWIZZLE_ROW
    part1 = swizzle_rows(w1t.reshape(KERNEL_SLICES, KERNEL_SLICE, blocks, SWIZZLE_ROW).permute(0, 2, 1, 3))
    part2 = swizzle_rows(w2t.reshape(KERNEL_MAX_CHANNELS, KERNEL_SLICES, KERNEL_SLICE).permute(1, 0, 2))
    wpack = torch.cat([part1.reshape(KERNEL_SLICES, -1), part2.reshape(KERNEL_SLICES, -1)], dim=1).contiguous()
    bias = torch.zeros(KERNEL_MAX_HIDDEN + KERNEL_MAX_CHANNELS, dtype=torch.float32, device=dev)
    bias[:hidden] = b1
    bias[KERNEL_MAX_HIDDEN:KERNEL_MAX_HIDDEN + c] = b2
    return wpack, bias


class PackedWeights:
    """One module's ``pack_weights`` layout, laid out at its first call on a
    card (the warm-up, before any CUDA graph capture) and again only when a
    weight is replaced or written in place. It holds the weights it was laid
    out from, so no other tensor can take their addresses while it does."""

    def __init__(self) -> None:
        self._source: tuple = ()
        self._versions: tuple = ()
        self._packed: tuple[torch.Tensor, torch.Tensor] | None = None

    def get(self, *weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        versions = tuple((w.data_ptr(), -1 if w.is_inference() else w._version) for w in weights)
        if self._packed is None or versions != self._versions:
            with torch.no_grad():
                self._packed = pack_weights(*weights)
            self._source = tuple(w.detach() for w in weights)
            self._versions = versions
        return self._packed


class SwinMlpKernel(build.Kernel):
    """ctypes binding of ``irp_swin_mlp`` with its launch count."""

    name, variants = "swin_mlp", ("bf16",)
    source, symbol = SOURCE, "irp_swin_mlp"
    argtypes = (*[ctypes.c_void_p] * 4, *[ctypes.c_int] * 3)

    def __call__(self, x: torch.Tensor, wpack: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """x [M, C] CUDA bf16, contiguous and 16-byte aligned; ``wpack`` and
        ``bias`` from ``pack_weights`` on its device -> m [M, C] bf16."""
        tensors = (x, wpack, bias)
        if x.dim() != 2 or x.shape[0] < 1:
            raise ValueError(f"the tokens must be [M, C] with M >= 1, got {tuple(x.shape)}")
        if x.dtype != torch.bfloat16 or wpack.dtype != torch.bfloat16 or bias.dtype != torch.float32:
            raise TypeError(f"the MLP kernel takes bf16 tokens and packed weights and f32 biases, got "
                            f"{[t.dtype for t in tensors]}")
        m, c = x.shape
        check_shapes(c, 1)
        packed = (KERNEL_SLICES, (KERNEL_DEPTH + KERNEL_MAX_CHANNELS) * KERNEL_SLICE)
        if tuple(wpack.shape) != packed or tuple(bias.shape) != (KERNEL_MAX_HIDDEN + KERNEL_MAX_CHANNELS,):
            raise ValueError(f"the packed weights must be {list(packed)} and [{KERNEL_MAX_HIDDEN + KERNEL_MAX_CHANNELS}], "
                             f"got {tuple(wpack.shape)} and {tuple(bias.shape)}")
        if not all(t.is_contiguous() for t in tensors) or any(t.data_ptr() % 16 for t in tensors):
            raise ValueError("the MLP kernel takes contiguous, 16-byte aligned tensors")
        if not all(t.is_cuda and t.device == x.device for t in tensors):
            raise ValueError("the MLP kernel takes CUDA tensors on one device only")
        grid = min(-(-m // UNIT_ROWS), torch.cuda.get_device_properties(x.device).multi_processor_count)
        out = torch.empty_like(x)
        self.launch(x.device, "bf16", x.data_ptr(), wpack.data_ptr(), bias.data_ptr(), out.data_ptr(), m, c, grid)
        return out


swin_mlp_kernel = SwinMlpKernel()


def swin_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
             packed: PackedWeights) -> torch.Tensor:
    """x [..., C] -> GELU(x w1 + b1) w2 + b2 [..., C], w1 [C, H], w2 [H, C]
    (a ``Dense`` layer's [in, out] kernels). On a card the kernel reads the
    weights in ``packed``'s layout (the calling module's own)."""
    if x.device.type == "cpu":
        return swin_mlp_reference(x, w1, b1, w2, b2)
    check_shapes(*w1.shape)
    if not x.is_contiguous():
        raise ValueError("the MLP kernel takes contiguous tokens")
    wpack, bias = packed.get(w1, b1, w2, b2)
    return swin_mlp_kernel(x.view(-1, x.shape[-1]), wpack, bias).view(x.shape)
