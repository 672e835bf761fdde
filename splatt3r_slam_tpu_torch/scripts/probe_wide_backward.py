"""The bf16 wide-head-dim flash backward pair on the card, taken apart:
where a block's time goes in the tile loop of `flash_bwd_wide_bf16`
(dK/dV and dQ), and the variants of it that were measured and not kept.

    python -m splatt3r_slam_tpu_torch.scripts.probe_wide_backward
        [--rounds 5]

Altered copies of `csrc/flash_attention_bwd.cu` are written under
`_build/probe_wide_bwd/` and built with nvcc beside the checkout's own
library. `phases`: both instances of the bf16 wide kernel with the SM's
clock (clock64) read by thread 0 of every block around each step of the
tile loop, the steps' cycles summed over the blocks into a device array
(`flash_probe_read` copies it out). The steps:

- `loads`: tile j + 1's owner loads issued (the first four ranks' partials
  of S and dP, through distributed shared memory);
- `gradients`: tile j's P or dS fragments read and its gradient products
  issued;
- `contraction`: tile j + 2's streamed slices waited for and its partial
  of S or dP issued (with passes above Dh 1024, each slice waited for);
- `owners`: tile j + 1's partials added in rank order (the other ranks'
  loads in place), P and dS formed and pushed to every block;
- `retire`: the tensor cores waited for (both groups);
- `partials`: tile j + 2's partial written to shared memory;
- `copies`: the block barrier and tile j + 3's copies issued;
- `barrier`: the cluster barrier.

The variants (`VARIANTS`), each the kept kernel with one change:

- `pieces8`: the exchange in 8-byte pieces: the partials written a float2
  at a time (a unit's two row halves 1 KiB apart), read so, and P and dS
  pushed as two 8-byte pieces into buffers of their own;
- `local`: the block's own partials read, and its own fragments written,
  by plain shared-memory accesses in place of the cluster's;
- `after`: the next tile's copies issued after the cluster barrier, a copy
  a warp, with no block barrier before them;
- `wgcopies`: each warpgroup issues the copies of the tensors it reads,
  after a barrier of its own warps, with no block barrier.

Printed per row and kernel as cycles a block per tile, with the clocked
copy's and each variant's device time beside the kept kernel's, in turns
(the clock reads and their registers slow the clocked copy), and whether
each gives the kept kernel's bits (every variant sums in the same order).
Times are device times (20 launches behind a device-side delay, two CUDA
events), the median of `--rounds`. The alteration finds its places by the
source's text and stops with an error where it has changed. Runs on the
card only. The last line of stdout is the result as JSON: {"rows": {row:
{...}}, "device", "power_limit_w"}.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess

import torch

from splatt3r_slam_tpu_torch import cuda_build, set_fp32_precision
from splatt3r_slam_tpu_torch.models import flash_attention as fl
from splatt3r_slam_tpu_torch.scripts._common import (SLEEP_CYCLES,
                                                     device_fields)
from splatt3r_slam_tpu_torch.scripts.probe_wide_forward import (_one,
                                                                _registers)

# (label, B, n_q, n_kv, H, Dh): chip_smoke.py's bf16 wide rows
ROWS = (
    ("N768 H8 Dh512", 1, 768, 768, 8, 512),
    ("Nq256 Nkv512 H4 Dh384", 1, 256, 512, 4, 384),
    ("Nq256 Nkv512 H4 Dh512", 1, 256, 512, 4, 512),
    ("Nq256 Nkv512 H2 Dh1024", 1, 256, 512, 2, 1024),
    ("Nq256 Nkv512 H1 Dh1152", 1, 256, 512, 1, 1152),
)
PHASES = ("loads", "gradients", "contraction", "owners", "retire",
          "partials", "copies", "barrier")
NAMES = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")
ITERS = 20

# the tile loop's steps: each ends after its text
_AFTER = ("    if (j + 1 < tiles) own_pref(j + 1);\n", "    consume(j);\n",
          "    if (j + 2 < tiles) contract(j + 2);\n",
          "    if (j + 1 < tiles) own_fin(j + 1);\n",
          "    hold(acc);\n    hold(fa);\n    hold(sc);\n",
          "    if (j + 2 < tiles) publish(j + 2);\n",
          "    if (tid == 0 && j + 3 < tiles) load_item(j + 3, 0);\n"
          "    __syncwarp();\n",
          "    cluster_sync();  // P and dS of tile j + 1, partials of tile "
          "j + 2 seen\n")
_LOOP = "  for (int j = 0; j < tiles; ++j) {\n    if (j + 1 < tiles) own_pref"
_KERNEL = ("template <bool DKV>\n__global__ void __launch_bounds__(WT, 1)\n"
           "    flash_bwd_wide_bf16(")
_CLOCK = ("    {{ const unsigned long long t_ = clock64(); pc_[{k}] += t_ - "
          "pt_; pt_ = t_; }}\n")

_LOOP_COPIES = """    __syncthreads();  // tile j's stage takes tile j + 3
    if (tid == 0 && j + 3 < tiles) load_item(j + 3, 0);
    __syncwarp();
    cluster_sync();  // P and dS of tile j + 1, partials of tile j + 2 seen
"""
_BARS = """  if (tid == 0) {
    for (int s = 0; s <= BW_ST; ++s) bar_init(bars + 8 * s);
"""
# (the kept text, the variant's) pairs, each found once in the source
VARIANTS = {
    "pieces8": (
        ("""    float4* pw = reinterpret_cast<float4*>(sm + BW_PART +""",
         """    float2* pw = reinterpret_cast<float2*>(sm + BW_PART +"""),
        ("""    for (int nt = 0; nt < 8; ++nt)
      pw[nt * WG + t] = make_float4(sc[4 * nt], sc[4 * nt + 1],
                                    sc[4 * nt + 2], sc[4 * nt + 3]);
""", """    for (int k = 0; k < 16; ++k)
      pw[k * WG + t] = make_float2(sc[2 * k], sc[2 * k + 1]);
"""),
        ("""  using Loads = float4[RB][2];  // [rank][S, dP]
""", """  using Loads = float2[RB][2][2];
"""),
        ("""                         (nt * WG + at) * 16;
#pragma unroll
      for (int mat = 0; mat < 2; ++mat)
        x[qq][mat] = here ? ld_dsmem4(a + mat * BW_PM)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
""", """                         (2 * nt * WG + at) * 8;
#pragma unroll
      for (int mat = 0; mat < 2; ++mat)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          x[qq][mat][hh] = here ? ld_dsmem(a + mat * BW_PM + hh * WG * 8)
                                : make_float2(0.f, 0.f);
"""),
        ("""          for (int mat = 0; mat < 2; ++mat) {
            const float4 v = y[qq][mat];
            a[mat][0] = q0 + qq == 0 ? make_float2(v.x, v.y)
                                     : make_float2(a[mat][0].x + v.x,
                                                   a[mat][0].y + v.y);
            a[mat][1] = q0 + qq == 0 ? make_float2(v.z, v.w)
                                     : make_float2(a[mat][1].x + v.z,
                                                   a[mat][1].y + v.w);
          }
""", """          for (int mat = 0; mat < 2; ++mat)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float2 v = y[qq][mat][hh];
              a[mat][hh] = q0 + qq == 0 ? v
                                        : make_float2(a[mat][hh].x + v.x,
                                                      a[mat][hh].y + v.y);
            }
"""),
        ("""                         (nt * WG + at) * (DKV ? 16 : 8);
""", """                         ((nt >> 1) * WG + at) * 16 + (nt & 1) * 8;
"""),
        ("""        if constexpr (DKV)
          st_dsmem(rb, make_uint4(pv[0], pv[1], dv[0], dv[1]));
        else
          st_dsmem(rb, make_uint2(dv[0], dv[1]));
""", """        if (DKV) st_dsmem(rb, make_uint2(pv[0], pv[1]));
        st_dsmem(rb + BW_FM, make_uint2(dv[0], dv[1]));
"""),
        ("""    const unsigned char* fr = sm + BW_FRAG + (j & 1) * 2 * BW_FM +
                              (DKV && wg == 0 ? 8 : 0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint2 x = *reinterpret_cast<const uint2*>(
          fr + (nt * WG + t) * (DKV ? 16 : 8));
      fa[nt >> 1][2 * (nt & 1)] = x.x;
      fa[nt >> 1][2 * (nt & 1) + 1] = x.y;
    }
""", """    const uint4* fr = reinterpret_cast<const uint4*>(
        sm + BW_FRAG + (j & 1) * 2 * BW_FM + (DKV && wg == 1 ? 0 : BW_FM));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint4 x = fr[kk * WG + t];
      fa[kk][0] = x.x;
      fa[kk][1] = x.y;
      fa[kk][2] = x.z;
      fa[kk][3] = x.w;
    }
"""),
    ),
    "local": (
        ("""      const uint32_t a = (here ? cluster_map(base, q0 + qq) : 0) + part +
                         (nt * WG + at) * 16;
#pragma unroll
      for (int mat = 0; mat < 2; ++mat)
        x[qq][mat] = here ? ld_dsmem4(a + mat * BW_PM)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
""", """      const bool own = q0 + qq == rank;
      const uint32_t a = (here && !own ? cluster_map(base, q0 + qq) : 0) +
                         part + (nt * WG + at) * 16;
#pragma unroll
      for (int mat = 0; mat < 2; ++mat)
        x[qq][mat] = !here ? make_float4(0.f, 0.f, 0.f, 0.f)
                     : own ? *reinterpret_cast<const float4*>(
                                 sm + part + (nt * WG + at) * 16 + mat * BW_PM)
                           : ld_dsmem4(a + mat * BW_PM);
"""),
        ("""      if (q < cs) {
        const uint32_t rb = cluster_map(base, q) + off;
        if constexpr (DKV)
          st_dsmem(rb, make_uint4(pv[0], pv[1], dv[0], dv[1]));
        else
          st_dsmem(rb, make_uint2(dv[0], dv[1]));
      }
""", """      if (q < cs && q != rank) {
        const uint32_t rb = cluster_map(base, q) + off;
        if constexpr (DKV)
          st_dsmem(rb, make_uint4(pv[0], pv[1], dv[0], dv[1]));
        else
          st_dsmem(rb, make_uint2(dv[0], dv[1]));
      }
    if constexpr (DKV)
      *reinterpret_cast<uint4*>(sm + off) =
          make_uint4(pv[0], pv[1], dv[0], dv[1]);
    else
      *reinterpret_cast<uint2*>(sm + off) = make_uint2(dv[0], dv[1]);
"""),
    ),
    "after": (
        (_BARS, """  auto load_copy = [&](int j, int x) {
    const int s = j % BW_ST;
    const uint32_t bar = bars + 8 * s, dst = base + BW_STG + s * 2 * BW_SLICE;
    if (x == 0) bar_expect(bar, 2 * BW_SLICE + (DKV ? 3 * ROWS * 4 : 0));
    if (x < 4) {
      tma_box(dst + (x >> 1) * BW_SLICE + (x & 1) * BOX,
              x < 2 ? &tp.s1 : &tp.s2, WC * rank + 64 * (x & 1), j * ROWS, h,
              b, bar);
    } else if (DKV && x < 7) {
      const float* src = x == 4 ? p.m : (x == 5 ? p.l : p.di);
      bulk_copy(smem_addr(stats + s * 3 * ROWS + (x - 4) * ROWS),
                src + sbase + static_cast<long long>(j) * ROWS, ROWS * 4,
                bar);
    }
  };

""" + _BARS),
        (_LOOP_COPIES, """    if (multi) {
      __syncthreads();
      if (tid == 0 && j + 3 < tiles) load_item(j + 3, 0);
      __syncwarp();
    }
    cluster_sync();
    if (!multi && (tid & 31) == 0 && j + 3 < tiles) load_copy(j + 3, tid >> 5);
    __syncwarp();
"""),
    ),
    "wgcopies": (
        (_BARS, """  auto load_copies = [&](int j) {
    const int s = j % BW_ST, x = warp;
    const uint32_t bar = bars + 8 * s,
                   dst = base + BW_STG + s * 2 * BW_SLICE;
    if (wg == 0 && x == 0)
      bar_expect(bar, 2 * BW_SLICE + (DKV ? 3 * ROWS * 4 : 0));
    const int cpy = DKV ? (x < 2 ? x + 2 * wg : (wg == 0 ? x + 2 : 4 * x - 2))
                        : (wg == 0 ? (x == 0 ? 0 : 8) : (x < 3 ? x + 1 : 8));
    if (cpy < 4) {
      tma_box(dst + (cpy >> 1) * BW_SLICE + (cpy & 1) * BOX,
              cpy < 2 ? &tp.s1 : &tp.s2, WC * rank + 64 * (cpy & 1),
              j * ROWS, h, b, bar);
    } else if (DKV && cpy < 7) {
      const float* from = cpy == 4 ? p.m : (cpy == 5 ? p.l : p.di);
      bulk_copy(smem_addr(stats + s * 3 * ROWS + (cpy - 4) * ROWS),
                from + sbase + static_cast<long long>(j) * ROWS, ROWS * 4,
                bar);
    }
  };

""" + _BARS),
        (_LOOP_COPIES, """    if (j + 3 < tiles) {
      if (multi) {
        __syncthreads();
        if (tid == 0) load_item(j + 3, 0);
      } else {
        named_sync(2 + wg, WG);
        if ((tid & 31) == 0) load_copies(j + 3);
      }
      __syncwarp();
    }
    cluster_sync();
"""),
    ),
}


def phases_source(src):
    """The source with both instances of the bf16 wide kernel clocked."""
    a = _one(src, _KERNEL)
    z = src.index("\n}\n", a) + 3
    body = src[a:z]
    i = _one(body, _LOOP)
    body = (body[:i] + "  unsigned long long pc_[8] = {0, 0, 0, 0, 0, 0, 0, "
            "0}, pt_ = clock64(), p0_ = pt_;\n" + body[i:])
    for k, text in enumerate(_AFTER):
        i = _one(body, text) + len(text)
        body = body[:i] + _CLOCK.format(k=k) + body[i:]
    i = body.index("\n  }\n", i) + len("\n  }\n")
    body = body[:i] + (
        "  if (tid == 0) {\n"
        "    unsigned long long* pr = flash_probe[DKV ? 0 : 1];\n"
        "    for (int k = 0; k < 8; ++k) atomicAdd(&pr[k], pc_[k]);\n"
        "    atomicAdd(&pr[8], clock64() - p0_);\n"
        "    atomicAdd(&pr[9], 1ull);\n"
        "    atomicAdd(&pr[10], (unsigned long long)tiles);\n"
        "  }\n") + body[i:]
    out = src[:a] + body + src[z:]
    inc = '#include "flash_common.cuh"'
    i = _one(out, inc)
    out = (out[:i] + inc
           + "\n__device__ unsigned long long flash_probe[2][11];"
           + out[i + len(inc):])
    return out + (
        "\n// the step clocks of both instances: [dK/dV, dQ][8 steps, the "
        "loop, blocks, tiles]\n"
        'extern "C" int flash_probe_read(unsigned long long* out) {\n'
        "  return static_cast<int>(\n"
        "      cudaMemcpyFromSymbol(out, flash_probe, sizeof(flash_probe)));\n"
        "}\n\n"
        'extern "C" int flash_probe_reset() {\n'
        "  const unsigned long long zero[22] = {};\n"
        "  return static_cast<int>(\n"
        "      cudaMemcpyToSymbol(flash_probe, zero, sizeof(zero)));\n"
        "}\n")


def variant_source(src, name):
    """The source with the bf16 wide kernel altered as `VARIANTS[name]`."""
    for kept, alt in VARIANTS[name]:
        i = _one(src, kept)
        src = src[:i] + alt + src[i + len(kept):]
    return src


def _start(name, text):
    """Write a copy of the source (with the header beside it) and start
    its nvcc → (library, process)."""
    source = cuda_build.KERNELS[NAMES[0]][0]
    d = cuda_build.BUILD_DIR / "probe_wide_bwd" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / source.name).write_text(text)
    shutil.copy(source.parent / "flash_common.cuh", d)
    so = d / "libflash_attention_bwd.so"
    return so, subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
         str(d / source.name)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _with(entry, fn):
    """fn with the wrapper's launch of `entry`'s kernel going to it."""
    name, ptr = entry

    def run():
        own = cuda_build._fns[name]
        cuda_build._fns[name] = ptr
        try:
            return fn()
        finally:
            cuda_build._fns[name] = own
    return run


def _device_ms(fn):
    """Device ms of one fn(): ITERS calls behind a device-side delay long
    enough for the host to enqueue them (a ctypes launch with its checks),
    two CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10 * SLEEP_CYCLES)
    a.record()
    for _ in range(ITERS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / ITERS


def _in_turns(fns, rounds):
    """Device ms of each fn, in turns (the order flipped every round), the
    median over `rounds`."""
    got = [[] for _ in fns]
    for r in range(rounds):
        order = list(enumerate(fns))
        for i, fn in (order if r % 2 == 0 else order[::-1]):
            got[i].append(_device_ms(fn))
    return [statistics.median(x) for x in got]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_wide_backward runs on cuda: no card here")
    set_fp32_precision()
    src = cuda_build.KERNELS[NAMES[0]][0].read_text()
    started = {"phases": _start("phases", phases_source(src))}
    started.update({n: _start(n, variant_source(src, n)) for n in VARIANTS})
    logs = {"kept": cuda_build.build([NAMES[0]])[NAMES[0]][1]}
    libs = {}
    for name, (so, proc) in started.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{err}")
        libs[name], logs[name] = so, out + err
    for inst in ("ILb1E", "ILb0E"):
        kernel = f"flash_bwd_wide_bf16{inst}"
        print(f"[ptxas] {kernel}: registers and spill store bytes, "
              + ", ".join(f"{n} {_registers(log, kernel)}"
                          for n, log in logs.items()), flush=True)
    x = torch.zeros(1, 64, 1, 64, device="cuda", dtype=torch.bfloat16)
    ones = torch.ones(1, 1, 64, device="cuda")
    fl.flash_attention_bwd(x, x, x, x, ones, ones, x, 0.125)  # resolves both
    probe = ctypes.CDLL(str(libs["phases"]))
    counts = (ctypes.c_ulonglong * 22)()

    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = {}
    for label, B, nq, nk, nh, D in ROWS:
        q, k, v, do = (torch.randn(B, n, nh, D, device="cuda",
                                   generator=gen).to(torch.bfloat16)
                       for n in (nq, nk, nk, nq))
        scale = D ** -0.5
        o, l, m = fl.flash_attention(q, k, v, scale, residuals=True)
        di = fl._di(o, do.contiguous())
        kinds = {
            "dkv": (NAMES[0], lambda: fl._launch_dkv(q, k, v, do, m, l, di,
                                                     scale)),
            "dq": (NAMES[1], lambda: fl._launch_dq(q, k, v, do, m, l, di,
                                                   scale))}
        for di_, (kind, (name, fn)) in enumerate(kinds.items()):
            alts = {n: _with((name, cuda_build._entry(so, name)), fn)
                    for n, so in libs.items()}
            want = fn()
            want = want if isinstance(want, tuple) else (want,)
            same = {}
            for n, alt in alts.items():
                got = alt()
                torch.cuda.synchronize()
                same[n] = all(torch.equal(a, b) for a, b in zip(
                    want, got if isinstance(got, tuple) else (got,)))
            probe.flash_probe_reset()
            alts["phases"]()
            torch.cuda.synchronize()
            probe.flash_probe_read(counts)
            c = list(counts)[11 * di_:11 * di_ + 11]
            row = {"cycles_per_tile": {p: c[i] / c[10]
                                       for i, p in enumerate(PHASES)},
                   "loop_cycles_per_tile": c[8] / c[10], "blocks": c[9],
                   "same_bits": same}
            ms = _in_turns([fn, *alts.values()], args.rounds)
            row["ms"] = ms[0]
            row["variant_ms"] = dict(zip(alts, ms[1:]))
            key = f"{kind} {label}"
            rows[key] = row
            print(f"[probe] {key}: {row['ms']:.4f} ms; " + ", ".join(
                f"{n} {t:.4f} ({t / row['ms']:.3f}x, same bits {same[n]})"
                for n, t in row["variant_ms"].items())
                  + f" | cycles a block per tile (phases): loop "
                  f"{row['loop_cycles_per_tile']:.0f}; " + ", ".join(
                      f"{p} {n:.0f}"
                      for p, n in row["cycles_per_tile"].items())
                  + f" ({row['blocks']} blocks)", flush=True)
        del q, k, v, do, o
    fields = device_fields("cuda")
    print(f"{fields['device']}, {fields['power_limit_w']} W")
    print(json.dumps({"rows": rows, **fields}))


if __name__ == "__main__":
    main()
