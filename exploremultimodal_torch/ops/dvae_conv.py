"""The fused dVAE encoder block (row 11) and its route selector.

Counterpart of `exploremultimodal_tpu/ops/dvae_conv.py`'s
`fused_encoder_block` / `_block_kernel`: one `EncoderBlock` (+ its group's
2x2 max-pool) in one kernel, `csrc/dvae_block.cu`. `MAX_FUSED_CIN`,
`VMEM_BUDGET`, `_vmem_estimate` and `_pick_row_tile` are JAX's, copied
verbatim as a route selector only (`fuses`), so that both packages fuse the
same blocks; the CUDA kernel tiles by its own rules. The encoder forward
that uses them (JAX's `encoder_apply_fused`) is
`models.dvae.DalleEncoder.forward(x, fused=True)`, whose `EncoderBlock`s
are JAX's `_xla_block`. Tensors are NHWC, as in JAX; a block's parameters
are the port's `EncoderBlock` module. The wrapper runs the kernel on CUDA
tensors and `fused_encoder_block_plain` on CPU tensors; there is no other
fallback.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from exploremultimodal_torch.ops import _build

# fuse a residual block in Pallas only when its weights fit VMEM comfortably
MAX_FUSED_CIN = 512
# target VMEM footprint per program (bytes); halve the row tile until it
# fits. Calibrated against measured Mosaic compiles on v5e (16 MiB VMEM):
# estimates ≤15 MiB compiled, ≥16.4 MiB hit scoped-vmem OOM.
VMEM_BUDGET = 15 * 1024 * 1024

# the widths the kernel takes: the OpenAI encoder's at n_hid 256
KERNEL_HIDDEN = (64, 128, 256)
KERNEL_CIN = (256, 512)
KERNEL_COUT = (256, 512, 1024)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 12 + [_I] * 8 + [ctypes.c_float, _P]
_GRID_ARGS = [_I] * 4 + [ctypes.POINTER(ctypes.c_int)] * 4


def _vmem_estimate(T: int, W: int, cin: int, nh: int, cout: int,
                   itemsize: int) -> int:
    """Rough per-program VMEM bytes: input strip scratch + its live value
    copy + dy-stacked patches + fp32 conv accumulators + double-buffered
    output block, plus resident weights."""
    ch = 8 if itemsize == 4 else 16
    khi = 3 * nh if nh < 128 else nh  # dy-stacked contraction width
    act = (
        (T + 6) * (W + 2 * ch) * cin          # xs scratch
        + (T + 6) * (W + 6) * cin             # sliced/relu'd value
        + (T + 4) * (W + 6) * khi             # patches for conv2
        + 2 * T * W * cout                    # double-buffered out block
    ) * itemsize
    acc = (T + 4) * (W + 4) * max(nh, cout) * 4 * 2  # fp32 accumulators
    weights = (9 * (cin * nh + 2 * nh * nh) + nh * cout + cin * cout) * itemsize
    return act + acc + weights


def _pick_row_tile(H: int, W: int, cin: int, nh: int, cout: int,
                   itemsize: int) -> int | None:
    # T=2 is excluded: single-output-row programs crash the v5e runtime
    for T in (16, 8, 4):
        if H % T == 0 and _vmem_estimate(T, W, cin, nh, cout, itemsize) \
                <= VMEM_BUDGET:
            return T
    return None


def block_widths(params) -> tuple[int, int, int]:
    """(cin, nh, cout) of an `EncoderBlock`."""
    cout, nh = params.conv_4.conv.weight.shape[:2]
    return params.conv_1.conv.weight.shape[1], nh, cout


def fuses(params, h: int, w: int, itemsize: int) -> bool:
    """JAX's predicate (`encoder_apply_fused`): the block fuses where cin <=
    MAX_FUSED_CIN, cin is a multiple of 128 and a row tile fits VMEM."""
    cin, nh, cout = block_widths(params)
    return (cin <= MAX_FUSED_CIN and cin % 128 == 0
            and _pick_row_tile(h, w, cin, nh, cout, itemsize) is not None)


def fused_encoder_block_plain(x: torch.Tensor, params, post_gain: float,
                              pool: bool = False) -> torch.Tensor:
    """`_block_kernel`'s function in fp32 with its roundings: weights cast
    to x's dtype, biases fp32; h1 and h2 rounded to the dtype (zero outside
    the image: the convs' own padding), h3 relu'd then rounded, h4 and the
    identity fp32, out = ident + post_gain * h4 rounded once, then pooled.
    x: (B, H, W, cin) NHWC."""
    dt = x.dtype

    def conv(t, c, pad):
        return F.conv2d(t, c.conv.weight.to(dt).float(), c.conv.bias.float(),
                        padding=pad)

    xc = x.permute(0, 3, 1, 2).float()
    h = conv(xc.clamp_min(0), params.conv_1, 1).to(dt)
    h = conv(h.float().clamp_min(0), params.conv_2, 1).to(dt)
    h = conv(h.float().clamp_min(0), params.conv_3, 1).clamp_min(0).to(dt)
    h = conv(h.float(), params.conv_4, 0)
    ident = conv(xc, params.id_conv, 0) if params.id_conv is not None else xc
    out = (ident + post_gain * h).to(dt)
    if pool:
        out = F.max_pool2d(out.float(), 2).to(dt)
    return out.permute(0, 2, 3, 1).contiguous()


def _check(x: torch.Tensor, params, pool: bool) -> tuple[int, int, int]:
    cin, nh, cout = block_widths(params)
    b, h, w, c = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"fused_encoder_block: x must be a contiguous, 16-byte "
                         f"aligned bf16 NHWC tensor, got {x.dtype}")
    if c != cin or nh not in KERNEL_HIDDEN or cin not in KERNEL_CIN \
            or cout not in KERNEL_COUT or cout != 4 * nh:
        raise ValueError(
            f"fused_encoder_block: the kernel takes the OpenAI widths only (nh "
            f"{KERNEL_HIDDEN}, cin {KERNEL_CIN}, cout {KERNEL_COUT} = 4 nh); got "
            f"cin {c} (block {cin}), nh {nh}, cout {cout}")
    if pool and (h % 2 or w % 2):
        raise ValueError(f"fused_encoder_block: pooling needs an even size, got {h}x{w}")
    if any(p.device != x.device for p in params.parameters()):
        raise ValueError("fused_encoder_block: x and the block's weights must "
                         "be on one device")
    return cin, nh, cout


def _kernel_weights(params, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """The block's weights in the kernel's layouts: 3x3 kernels [tap][out][in]
    and 1x1 kernels [out][in] in `dtype`, biases fp32. Built once and kept
    on the block (the tokenizer is frozen); built again only when a weight
    moves, changes in place or `dtype` differs."""
    key = (dtype, tuple((p.data_ptr(), p._version) for p in params.parameters()))
    cached = getattr(params, "_kernel_weights_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]

    def w3(c):
        return c.conv.weight.to(dtype).permute(2, 3, 0, 1).contiguous()

    def w1(c):
        return c.conv.weight.to(dtype)[:, :, 0, 0].contiguous()

    out = {"w1": w3(params.conv_1), "w2": w3(params.conv_2), "w3": w3(params.conv_3),
           "w4": w1(params.conv_4)}
    names = ("conv_1", "conv_2", "conv_3", "conv_4") + (
        ("id_conv",) if params.id_conv is not None else ())
    for name in names:
        out[name] = getattr(params, name).conv.bias.float().contiguous()
    if params.id_conv is not None:
        out["wid"] = w1(params.id_conv)
    params._kernel_weights_cache = (key, out)
    return out


@torch.no_grad()
def fused_encoder_block(x: torch.Tensor, params, post_gain: float,
                        pool: bool = False) -> torch.Tensor:
    """One `EncoderBlock` (`params`) and, with `pool`, its 2x2 max-pool on
    x (B, H, W, cin) NHWC: the kernel on CUDA tensors (bf16, the OpenAI
    widths; anything else raises), `fused_encoder_block_plain` on CPU
    tensors. Forward only, as JAX's: the tokenizer is frozen."""
    if x.device.type == "cpu":
        return fused_encoder_block_plain(x, params, post_gain, pool)
    cin, nh, cout = _check(x, params, pool)
    b, h, w, _ = x.shape
    kw = _kernel_weights(params, x.dtype)
    out = torch.empty((b, h // 2, w // 2, cout) if pool else (b, h, w, cout),
                      dtype=x.dtype, device=x.device)
    has_id = params.id_conv is not None
    wid, bid = ((kw["wid"].data_ptr(), kw["id_conv"].data_ptr()) if has_id
                else (None, None))
    fn = _build.load("dvae_block", _ARGS)
    rc = fn(x.data_ptr(), kw["w1"].data_ptr(), kw["conv_1"].data_ptr(),
            kw["w2"].data_ptr(), kw["conv_2"].data_ptr(), kw["w3"].data_ptr(),
            kw["conv_3"].data_ptr(), kw["w4"].data_ptr(), kw["conv_4"].data_ptr(),
            wid, bid, out.data_ptr(), b, h, w, cin, nh, cout, int(has_id), int(pool),
            post_gain, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("dvae_block", rc)
    fused_encoder_block.launches += 1
    return out


fused_encoder_block.launches = 0


def kernel_grid(nh: int, h: int, w: int, batch: int) -> tuple[int, str, int]:
    """(CTAs launched, output tile "TRxTC", CTAs per cluster) of the kernel
    at hidden width nh on a batch of h x w images (needs the card)."""
    tr, tc, grid, cl = (ctypes.c_int() for _ in range(4))
    fn = _build.load("dvae_block", _GRID_ARGS, "dvae_block_grid")
    _build.check("dvae_block_grid", fn(nh, h, w, batch, *map(ctypes.byref, (tr, tc, grid, cl))))
    return grid.value, f"{tr.value}x{tc.value}", cl.value
