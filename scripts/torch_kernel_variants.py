#!/usr/bin/env python3
"""Time variants of the port's wgmma/TMA kernels side by side on one GPU.

    python3 scripts/torch_kernel_variants.py [spec.json [kind ...]]

Each variant is a kernel source of `exploremultimodal_torch/ops/csrc/` with
textual edits applied (the JSON, by default
scripts/torch_kernel_variants.json, maps a name to {"kind": "mlp" |
"mlp_drop" | "attn" | "attn_drop" | "attn_long" | "attn_stream" | "attn_stream_drop" |
"attn_bwd" | "w8a8_matmul" | "w8a8_mlp" | "w8a8_mlp_drop" | "dvae", "src": file,
"edits": [[old, new],
...]}; every
`old` must occur); kinds named after the file keep only their variants.
All variants are compiled at once with the package's
nvcc flags into a temporary directory, then each is swapped in for the
package's kernel and timed, in the order A B ... B A, at the shapes the
main paths give it: the bf16 fused MLP (row 6) at the serving M, its
dropout forward (row 7) at the finetune_vqa M, the short flash forward (row
1) at the batch-64 request's three streams, its dropout variant (row 3)
at the pretrain_mum step's four shapes, the long flash forward (row 5) at
the 1024^2 request's two streams, rows 1 and 3 past 256 keys on the same
streamed kernel (row 1 at N = 333, 512 and 577 at batch 8 and N = 512 at
batch 32, row 3 at N = 333 and 512 at batch 8 and 32), the backward (row 4 with dropout, row 2
without) at the pretrain_mum step's four shapes and at N = 256, 333 and 512
at batch 8 and N = 512 at batch 32, the W8A8 matmul (row 8) for proj and
qkv at the int8 step's and request's M, the W8A8 MLP (row 9) at
the int8
request's M and its dropout forward (row 10) at the int8 finetune_vqa M,
the dVAE block (row 11) at the five blocks the tokenizer fuses. A variant whose output leaves the kernel's
tolerance against the plain version is marked BAD (variants that skip work
are expected to be). Prints one JSON line per shape, with the card's name
and power limit first. Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from exploremultimodal_torch.ops import (  # noqa: E402
    _build,
    dvae_conv,
    flash_attention,
    mlp_fused,
    quant_fused,
)
from exploremultimodal_torch.ops.dvae_conv import (  # noqa: E402
    block_widths,
    fused_encoder_block,
    fused_encoder_block_plain,
)
from exploremultimodal_torch.ops.attention import key_padding_bias  # noqa: E402
from exploremultimodal_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bwd,
    flash_attention_bwd_drop,
    flash_attention_bwd_drop_plain,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_drop,
    flash_attention_fwd_drop_plain,
    flash_attention_fwd_long,
    flash_attention_fwd_long_plain,
    flash_attention_fwd_plain,
)
from exploremultimodal_torch.ops.mlp_fused import (  # noqa: E402
    fused_mlp_fwd,
    fused_mlp_fwd_drop,
    fused_mlp_fwd_drop_plain,
    fused_mlp_fwd_plain,
)
from exploremultimodal_torch.ops.quant_fused import (  # noqa: E402
    w8a8_mlp_fwd,
    w8a8_mlp_fwd_drop,
    w8a8_mlp_fwd_drop_plain,
    w8a8_mlp_fwd_plain,
)

MLP_ROWS = (64, 320, 2560, 4999, 12608, 15168, 32776)
# the entry points each kind swaps in, with their argument types
SYMBOL = {"mlp": {"fused_mlp_sm90": mlp_fused._SM90_ARGTYPES},
          "mlp_drop": {"fused_mlp_sm90_drop": mlp_fused._DROP_ARGTYPES},
          "attn": {"flash_attention_fwd_sm90": flash_attention._FWD_SM90_ARGS},
          "attn_drop": {"flash_attention_fwd_sm90": flash_attention._FWD_SM90_ARGS},
          "attn_long": {"flash_attention_long_sm90": flash_attention._FWD_LONG_ARGS},
          "attn_stream": {"flash_attention_long_sm90": flash_attention._FWD_LONG_ARGS},
          "attn_stream_drop": {"flash_attention_long_sm90": flash_attention._FWD_LONG_ARGS},
          "attn_bwd": {"flash_attention_bwd_sm90": flash_attention._BWD_SM90_ARGS},
          "w8a8_matmul": {"w8a8_matmul_sm90": quant_fused._MATMUL_ARGTYPES},
          "w8a8_mlp": {"w8a8_mlp_sm90": quant_fused._MLP_SM90_ARGTYPES},
          "w8a8_mlp_drop": {"w8a8_mlp_sm90_drop": quant_fused._MLP_SM90_DROP_ARGTYPES},
          "dvae": {"dvae_block": dvae_conv._ARGS}}


def build(spec: dict, out: Path) -> dict:
    procs = {}
    for name, v in spec.items():
        src = (_build.CSRC / v["src"]).read_text()
        for old, new in v.get("edits", []):
            if old not in src:
                raise ValueError(f"{name}: {old!r} not in {v['src']}")
            src = src.replace(old, new)
        path = out / f"{name}.cu"
        path.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(out / f"lib{name}.so"), str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        fns[name] = {}
        for symbol, argtypes in SYMBOL[spec[name]["kind"]].items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name][symbol] = fn
    return fns


def compare(names, fns, run, check, **timing) -> dict:
    """ms of each variant, in the order A B ... B A; a failed check marks it BAD."""
    res = {}
    for name in names + names[::-1]:
        _build._loaded.update(fns[name])
        ok, err = check()
        res.setdefault(name, []).append(cs.time_ms(run, **timing))
        if not ok:
            res[name].append(f"BAD {err}")
    return res


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    path = Path(argv[0]) if argv else Path(__file__).with_suffix(".json")
    spec = json.loads(path.read_text())
    if argv[1:]:
        spec = {n: v for n, v in spec.items() if v["kind"] in argv[1:]}
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(spec, Path(tmp))
    mlp = [n for n in spec if spec[n]["kind"] == "mlp"]
    mlp_drop = [n for n in spec if spec[n]["kind"] == "mlp_drop"]
    attn = [n for n in spec if spec[n]["kind"] == "attn"]
    attn_drop = [n for n in spec if spec[n]["kind"] == "attn_drop"]
    attn_long = [n for n in spec if spec[n]["kind"] == "attn_long"]
    attn_stream = [n for n in spec if spec[n]["kind"] == "attn_stream"]
    attn_stream_drop = [n for n in spec if spec[n]["kind"] == "attn_stream_drop"]
    w8a8_mlp = [n for n in spec if spec[n]["kind"] == "w8a8_mlp"]
    attn_bwd = [n for n in spec if spec[n]["kind"] == "attn_bwd"]
    w8a8_mlp_drop = [n for n in spec if spec[n]["kind"] == "w8a8_mlp_drop"]
    w8a8_matmul = [n for n in spec if spec[n]["kind"] == "w8a8_matmul"]
    dvae = [n for n in spec if spec[n]["kind"] == "dvae"]
    if mlp:
        cfg = cs.VlmoConfig.from_config(cs.load_config(cs.SERVE_OVERRIDES))
        g, w1, b1, w2, b2 = cs.mlp_weights(cfg, dev, 1)
        for m in MLP_ROWS:
            x = torch.randn((m, 768), generator=g, device=dev).to(torch.bfloat16)
            ref = fused_mlp_fwd_plain(x, w1, b1, w2, b2)
            res = compare(mlp, fns, lambda: fused_mlp_fwd(x, w1, b1, w2, b2),
                          lambda: cs.within(fused_mlp_fwd(x, w1, b1, w2, b2), ref,
                                            cs.MLP_ATOL, cs.MLP_RTOL))
            print(json.dumps({"kernel": "fused_mlp_fwd", "M": m, "ms": res}), flush=True)
    if mlp_drop:
        cfg = cs.VlmoConfig.from_config(cs.load_config(cs.VQA_OVERRIDES))
        g, w1, b1, w2, b2 = cs.mlp_weights(cfg, dev, 2)
        t = cs.MLP_DROP_THRESHOLDS[-1]
        for m in cs.vqa_mlp_rows(cfg):
            x = torch.randn((m, 768), generator=g, device=dev).to(torch.bfloat16)
            bits = torch.randint(-32768, 32768, (m, w1.shape[0]), dtype=torch.int16,
                                 generator=g, device=dev)
            ref = fused_mlp_fwd_drop_plain(x, w1, b1, w2, b2, bits, t)
            res = compare(mlp_drop, fns,
                          lambda: fused_mlp_fwd_drop(x, w1, b1, w2, b2, bits, t),
                          lambda: cs.within(fused_mlp_fwd_drop(x, w1, b1, w2, b2, bits, t),
                                            ref, cs.MLP_ATOL, cs.MLP_RTOL))
            print(json.dumps({"kernel": "fused_mlp_fwd_drop", "M": m, "ms": res}), flush=True)
    if attn:
        cfg = cs.VlmoConfig.from_config(cs.load_config(cs.SERVE_OVERRIDES))
        heads, d = cfg.num_heads, cfg.embed_dim // cfg.num_heads
        n_img = (cfg.img_size // cfg.patch_size) ** 2 + 1
        rng = np.random.default_rng(0)
        txt = cs.text_mask(rng, cs.BATCH, cfg.max_text_len)
        masks = {"text": txt, "image": np.ones((cs.BATCH, n_img), np.int32),
                 "fused": np.concatenate([txt, np.ones((cs.BATCH, n_img), np.int32)], 1)}
        for stream, mask in masks.items():
            n, bh = mask.shape[1], cs.BATCH * heads
            g = torch.Generator(device=dev).manual_seed(n)
            q, k, v = (torch.randn((bh, n, d), generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(3))
            kb = key_padding_bias(torch.from_numpy(mask).to(dev)).reshape(cs.BATCH, n)
            kb = kb.contiguous()
            ref = flash_attention_fwd_plain(q, k, v, kb, d ** -0.5)[0]
            res = compare(attn, fns,
                          lambda: flash_attention_fwd(q, k, v, kb, d ** -0.5),
                          lambda: cs.within(flash_attention_fwd(q, k, v, kb, d ** -0.5)[0],
                                            ref, cs.ATTN_ATOL, cs.ATTN_RTOL))
            print(json.dumps({"kernel": "flash_attention_fwd", "stream": stream, "N": n,
                              "ms": res}), flush=True)
    if w8a8_matmul:
        cfg = cs.VlmoConfig.from_config(cs.load_config(cs.W8A8_SERVE_OVERRIDES))
        g = torch.Generator(device=dev).manual_seed(4)
        for n_out in (768, 2304):
            w = (torch.randn((n_out, 768), generator=g, device=dev) * 0.02).to(torch.bfloat16)
            qw, sw = quant_fused.quantize_weights(w)
            for m in cs.vqa_mlp_rows(cfg) + cs.serve_rows(cfg):
                x = torch.randn((m, 768), generator=g, device=dev).to(torch.bfloat16)
                ref = quant_fused.w8a8_matmul_plain(x, qw, sw)
                res = compare(w8a8_matmul, fns, lambda: quant_fused.w8a8_matmul(x, qw, sw),
                              lambda: cs.within(quant_fused.w8a8_matmul(x, qw, sw), ref, 0.0,
                                                0.0))
                print(json.dumps({"kernel": "w8a8_matmul", "M": m, "N": n_out, "ms": res}),
                      flush=True)
    if w8a8_mlp:
        cfg = cs.VlmoConfig.from_config(cs.load_config(cs.W8A8_SERVE_OVERRIDES))
        g, _, args = cs.w8a8_mlp_weights(cfg, dev, 5)
        for m in cs.serve_rows(cfg):
            x = torch.randn((m, 768), generator=g, device=dev).to(torch.bfloat16)
            ref = w8a8_mlp_fwd_plain(x, *args)
            res = compare(w8a8_mlp, fns, lambda: w8a8_mlp_fwd(x, *args),
                          lambda: cs.within(w8a8_mlp_fwd(x, *args), ref, cs.W8A8_ATOL,
                                            cs.W8A8_RTOL))
            print(json.dumps({"kernel": "w8a8_mlp_fwd", "M": m, "ms": res}), flush=True)
    if attn_bwd or attn_drop:
        cfg = cs.VlmoConfig.from_config(cs.load_config(cs.TRAIN_OVERRIDES))
        heads, d = cfg.num_heads, cfg.embed_dim // cfg.num_heads
        rate, scale = cfg.attn_drop_rate, d ** -0.5
        n_img = (cfg.img_size // cfg.patch_size) ** 2 + 1
        rng = np.random.default_rng(1)
        txt = cs.synthetic_text_mask(rng, cs.TRAIN_BATCH, cfg.max_text_len)
        txt3 = np.concatenate([txt, txt, txt[rng.permutation(cs.TRAIN_BATCH)]])
        masks = {"text": txt, "image": np.ones((cs.TRAIN_BATCH, n_img), np.int32),
                 "fused": np.concatenate([txt, np.ones((cs.TRAIN_BATCH, n_img), np.int32)], 1),
                 "itm": np.concatenate([txt3, np.ones((3 * cs.TRAIN_BATCH, n_img), np.int32)],
                                       1)}
        if attn_bwd:  # the backward past the step's shapes, on its sm90 kernels
            masks.update({f"off_path_b{b}_n{n}": cs.padded_mask(rng, b, n)
                          for b, n in cs.TRAIN_OFF_PATH + ((cs.TXT_BATCH, cs.TXT_LEN),)
                          if (b, n) != (32, 333)})
        seed = torch.tensor([cs.DROP_SEED], dtype=torch.int32, device=dev)
        bwd_tol = [(cs.BWD_ATOL, cs.BWD_RTOL)] * 3
        fwd_tol = [(cs.ATTN_ATOL, cs.ATTN_RTOL), (cs.ATTN_LSE_ATOL, 0.0)]
        for stream, mask in masks.items():
            b, n = mask.shape
            g = torch.Generator(device=dev).manual_seed(b * 1000 + n)
            q, k, v, do = (torch.randn((b * heads, n, d), generator=g, device=dev)
                           .to(torch.bfloat16) for _ in range(4))
            kb = key_padding_bias(torch.from_numpy(mask).to(dev)).reshape(b, n).contiguous()
            o, lse = flash_attention_fwd_drop_plain(q, k, v, kb, seed, scale, rate)
            o0, lse0 = flash_attention_fwd_plain(q, k, v, kb, scale)
            runs = {  # kernel: (its kind's variants, run, plain version, tolerances)
                "flash_attention_bwd_drop": (
                    attn_bwd,
                    lambda: flash_attention_bwd_drop(q, k, v, kb, seed, o, do, lse, scale, rate),
                    lambda: flash_attention_bwd_drop_plain(q, k, v, kb, seed, o, do, lse, scale,
                                                           rate),
                    bwd_tol),
                "flash_attention_bwd": (
                    attn_bwd,
                    lambda: flash_attention_bwd(q, k, v, kb, o0, do, lse0, scale),
                    lambda: flash_attention_bwd_plain(q, k, v, kb, o0, do, lse0, scale),
                    bwd_tol),
                "flash_attention_fwd_drop": (  # the sm90 forward takes N <= 256
                    attn_drop if n <= flash_attention.SM90_FWD_MAX_N else [],
                    lambda: flash_attention_fwd_drop(q, k, v, kb, seed, scale, rate),
                    lambda: flash_attention_fwd_drop_plain(q, k, v, kb, seed, scale, rate),
                    fwd_tol),
            }
            for kernel, (names, run, plain, tols) in runs.items():
                if not names:
                    continue
                ref = plain()

                def check():
                    checks = [cs.within(x, y, atol, rtol)
                              for x, y, (atol, rtol) in zip(run(), ref, tols)]
                    return all(ok for ok, _ in checks), max(e for _, e in checks)

                res = compare(names, fns, run, check)
                print(json.dumps({"kernel": kernel, "stream": stream, "N": n, "BH": b * heads,
                                  "ms": res}), flush=True)
                del ref
            del q, k, v, do, o, lse, o0, lse0
            torch.cuda.empty_cache()
    if w8a8_mlp_drop:
        cfg = cs.VlmoConfig.from_config(cs.load_config(cs.W8A8_VQA_OVERRIDES))
        g, _, args = cs.w8a8_mlp_weights(cfg, dev, 6)
        t = cs.MLP_DROP_THRESHOLDS[-1]
        for m in cs.vqa_mlp_rows(cfg):
            x = torch.randn((m, 768), generator=g, device=dev).to(torch.bfloat16)
            bits = torch.randint(-32768, 32768, (m, args[0].shape[0]), dtype=torch.int16,
                                 generator=g, device=dev)
            ref = w8a8_mlp_fwd_drop_plain(x, *args, bits, t)
            res = compare(w8a8_mlp_drop, fns,
                          lambda: w8a8_mlp_fwd_drop(x, *args, bits, t),
                          lambda: cs.within(w8a8_mlp_fwd_drop(x, *args, bits, t), ref,
                                            cs.W8A8_ATOL, cs.W8A8_RTOL))
            print(json.dumps({"kernel": "w8a8_mlp_fwd_drop", "M": m, "ms": res}), flush=True)
    if attn_long:
        cfg = cs.VlmoConfig.from_config(cs.load_config(cs.HIRES_OVERRIDES))
        heads, d = cfg.num_heads, cfg.embed_dim // cfg.num_heads
        for n in ((cfg.img_size // cfg.patch_size) ** 2 + 1,
                  (cfg.img_size // cfg.patch_size) ** 2 + 1 + cfg.max_text_len):
            bh = cs.HIRES_BATCH * heads
            g = torch.Generator(device=dev).manual_seed(n)
            q, k, v = (torch.randn((bh, n, d), generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(3))
            kb = torch.zeros((cs.HIRES_BATCH, n), dtype=torch.float32, device=dev)
            kb[:, :cfg.max_text_len // 2] = -1e30
            ref = flash_attention_fwd_long_plain(q, k, v, kb, d ** -0.5)
            res = compare(attn_long, fns,
                          lambda: flash_attention_fwd_long(q, k, v, kb, d ** -0.5),
                          lambda: cs.within(flash_attention_fwd_long(q, k, v, kb, d ** -0.5),
                                            ref, cs.ATTN_ATOL, cs.ATTN_RTOL),
                          iters=10)
            print(json.dumps({"kernel": "flash_attention_fwd_long", "N": n, "ms": res}),
                  flush=True)
            del q, k, v, ref
            torch.cuda.empty_cache()
    if attn_stream or attn_stream_drop:
        cfg = cs.VlmoConfig.from_config(cs.load_config(cs.TRAIN_OVERRIDES))
        heads, d = cfg.num_heads, cfg.embed_dim // cfg.num_heads
        rate, scale = cfg.attn_drop_rate, d ** -0.5
        rng = np.random.default_rng(1)
        seed = torch.tensor([cs.DROP_SEED], dtype=torch.int32, device=dev)
        shapes = {(b, n) for b, n in cs.ATTN_OFF_PATH if n > flash_attention.SM90_FWD_MAX_N}
        shapes |= {(b, n) for b, n in cs.TRAIN_OFF_PATH if n > flash_attention.SM90_FWD_MAX_N}
        shapes.add((cs.TXT_BATCH, cs.TXT_LEN))
        for b, n in sorted(shapes):
            g = torch.Generator(device=dev).manual_seed(b * 1000 + n)
            q, k, v = (torch.randn((b * heads, n, d), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(3))
            kb = key_padding_bias(torch.from_numpy(cs.padded_mask(rng, b, n)).to(dev))
            kb = kb.reshape(b, n).contiguous()
            runs = {  # kernel: (its kind's variants, run, plain version)
                "flash_attention_fwd": (
                    attn_stream, lambda: flash_attention_fwd(q, k, v, kb, scale),
                    flash_attention_fwd_plain(q, k, v, kb, scale)),
                "flash_attention_fwd_drop": (
                    attn_stream_drop if n <= flash_attention.LONG_SEQ_THRESHOLD else [],
                    lambda: flash_attention_fwd_drop(q, k, v, kb, seed, scale, rate),
                    flash_attention_fwd_drop_plain(q, k, v, kb, seed, scale, rate)),
            }
            for kernel, (names, run, ref) in runs.items():
                if not names:
                    continue

                def check(run=run, ref=ref):
                    got = run()
                    oks = [cs.within(got[0], ref[0], cs.ATTN_ATOL, cs.ATTN_RTOL),
                           cs.within(got[1], ref[1], cs.ATTN_LSE_ATOL, 0.0)]
                    return all(ok for ok, _ in oks), max(e for _, e in oks)
                res = compare(names, fns, run, check)
                print(json.dumps({"kernel": kernel, "BH": b * heads, "N": n, "ms": res}),
                      flush=True)
            del q, k, v
            torch.cuda.empty_cache()
    if dvae:
        enc = cs.dvae_encoder(torch.bfloat16, dev)
        g = torch.Generator(device=dev).manual_seed(12)
        for name, pool, h in cs.dvae_block_shapes():
            blk = getattr(enc, name)
            x = torch.randn((cs.DVAE_BATCH, h, h, block_widths(blk)[0]), generator=g,
                            device=dev).to(torch.bfloat16)
            ref = fused_encoder_block_plain(x, blk, enc.post_gain, pool)
            res = compare(dvae, fns,
                          lambda: fused_encoder_block(x, blk, enc.post_gain, pool),
                          lambda: cs.within(fused_encoder_block(x, blk, enc.post_gain, pool),
                                            ref, cs.DVAE_ATOL, cs.DVAE_RTOL),
                          iters=5, warmup=1)
            print(json.dumps({"kernel": "fused_encoder_block", "block": name, "ms": res}),
                  flush=True)
            del x, ref
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
