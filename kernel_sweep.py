#!/usr/bin/env python3
"""Time variants of the port's flash kernels on one CUDA card.

    python3 kernel_sweep.py tiles            # the f32 kernel's W = 256 tiles
    python3 kernel_sweep.py against OLD.cu   # an older flash_attention_tc.cu
                                             # or flash_attention_tf32.cu

``tiles`` builds copies of ``ops/csrc/flash_attention_tf32.cu`` whose
W = 256 instantiation has other (warps, keys a tile), holds each to the
plain version at its tiles (ragged, ring-hop and fully masked cases, at
D = 256 and 200) and times them at [8, 8, 1024, 256] f32 causal in turns.
``against`` builds an older source of one of the two tensor-core
libraries (same C entry point; for example the parent commit's, from
``git show``) beside the current one and times both at [16, 8, 1024, 128]
causal in its dtype, in turns (old, new, new, old, ...). Builds go to
``build/kernel_sweep/``. Prints the card and, last, a JSON line of the
times (ms per launch, CUDA events).
"""
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "kernel_sweep")
TILES = ((4, 32), (8, 16), (6, 24), (4, 16), (6, 16))  # (warps, keys)
TURNS = 4  # timings of each variant, interleaved


def _build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """name -> library, all ``nvcc`` at once with the port's flags."""
    from vantage6_tpu_torch.ops import _build as B

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        so = os.path.join(OUT, name + ".so")
        procs[name] = (so, subprocess.Popen(
            [B._nvcc(), *B.ARCH_FLAGS, *B.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def _launcher(torch, lib, symbol, dtype_code):
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(q, k, v, q_offset, k_offset, causal, scale):
        o = torch.empty_like(q)
        b, h, t_q, d = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 dtype_code, b * h, t_q, k.shape[2], d, q_offset, k_offset,
                 int(causal), scale, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
        return o

    return run


def _in_turns(cs, runs: dict, iters: int = 30) -> dict[str, list[float]]:
    """ms per launch of each zero-argument callable, TURNS times each,
    the order reversed every other turn."""
    ms = {name: [] for name in runs}
    order = list(runs)
    for turn in range(TURNS):
        for name in (order if turn % 2 == 0 else order[::-1]):
            ms[name].append(cs.cuda_ms(runs[name], iters))
    return ms


def sweep_tiles(cs, torch, fa, dev):
    src = open(os.path.join(HERE, "vantage6_tpu_torch", "ops", "csrc",
                            "flash_attention_tf32.cu")).read()
    warps_line = "static constexpr int WARPS = 8;"
    keys_line = "static constexpr int BLOCK_K = D == 256 ? 16 : 64;"
    if warps_line not in src or keys_line not in src:
        raise RuntimeError("the W = 256 tile lines of the source moved")
    sources = {}
    for warps, keys in TILES:
        name = f"tf32_w256_{warps}x{keys}"
        path = os.path.join(OUT, name + ".cu")
        os.makedirs(OUT, exist_ok=True)
        with open(path, "w") as f:
            f.write(src.replace(
                warps_line,
                f"static constexpr int WARPS = D == 256 ? {warps} : 8;",
            ).replace(
                keys_line,
                f"static constexpr int BLOCK_K = D == 256 ? {keys} : 64;",
            ))
        sources[name] = path
    libs = _build(sources)
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(8, 8, 1024, 256, generator=g, device=dev)
               for _ in range(3))
    runs = {}
    for (warps, keys), (name, lib) in zip(TILES, libs.items()):
        run = _launcher(torch, lib, "v6t_flash_attention_fwd_tf32x3", 0)
        for d in (256, 200):
            for t_q, t_k, qo, ko, causal in ((200, 200, 0, 0, True),
                                             (130, 70, 0, 0, False),
                                             (150, 333, 183, 0, True),
                                             (257, 100, 37, 90, True)):
                qs, ks, vs = (torch.randn(1, 2, t, d, generator=g,
                                          device=dev)
                              for t in (t_q, t_k, t_k))
                out = run(qs, ks, vs, qo, ko, causal, d**-0.5)
                plain = fa.kernel_reference(qs, ks, vs, qo, ko, causal,
                                            d**-0.5, 16 * warps, keys)
                err = (out - plain).abs().max().item()
                lim = cs.F32_TOL * (1 + plain.abs().max().item())
                cs.check(err <= lim, f"{name} at D = {d} off its plain "
                         f"version: {err} > {lim}")
        runs[name] = (lambda run=run: run(q, k, v, 0, 0, True, 0.0625))
    print("each tile shape agrees with the plain version at its tiles")
    ms = _in_turns(cs, runs)
    sdpa = cs.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=0.0625), 30)
    for name, t in ms.items():
        print(f"{name} [8,8,1024,256] f32 causal: "
              + ", ".join(f"{x:.4f}" for x in t) + " ms")
    print(f"sdpa {sdpa:.4f} ms")
    return dict(shape="[8,8,1024,256] f32 causal", ms=ms, sdpa_ms=sdpa)


def against(cs, torch, fa, dev, old_path):
    base = os.path.basename(old_path)
    variant = {"flash_attention_tc.cu": "tensor_core",
               "flash_attention_tf32.cu": "tf32x3"}.get(base)
    if variant is None:
        raise SystemExit(f"{base}: give an old flash_attention_tc.cu or "
                         "flash_attention_tf32.cu")
    spec = fa.KERNELS[variant]
    dtype = spec.dtypes[0]
    old = _launcher(torch, _build({"old_" + spec.library: old_path})
                    ["old_" + spec.library], spec.symbol,
                    fa._KERNEL_DTYPES[dtype])
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(16, 8, 1024, 128, generator=g, device=dev)
               .to(dtype) for _ in range(3))
    scale = 128**-0.5
    new_out = fa.flash_forward_cuda(q, k, v, 0, 0, True, scale)
    diff = (old(q, k, v, 0, 0, True, scale).float()
            - new_out.float()).abs().max().item()
    ms = _in_turns(cs, {
        "old": lambda: old(q, k, v, 0, 0, True, scale),
        "new": lambda: fa.flash_forward_cuda(q, k, v, 0, 0, True, scale),
    })
    shape = f"[16,8,1024,128] {str(dtype).removeprefix('torch.')} causal"
    for name, t in ms.items():
        print(f"{variant} {name} {shape}: "
              + ", ".join(f"{x:.4f}" for x in t) + " ms")
    print(f"max |old - new| {diff:.3e}")
    return dict(variant=variant, shape=shape, ms=ms, max_abs_diff=diff)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from vantage6_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    dev = torch.device("cuda", 0)
    if argv[0] == "tiles":
        res = sweep_tiles(cs, torch, fa, dev)
    elif argv[0] == "against" and len(argv) == 2:
        res = against(cs, torch, fa, dev, argv[1])
    else:
        print(__doc__, file=sys.stderr)
        return 1
    print(json.dumps(dict(res, card=cs.card_line())))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
