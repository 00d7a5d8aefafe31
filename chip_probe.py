#!/usr/bin/env python3
"""Quick first call on the GPU after a kernel change: build, check, stop.

    python3 chip_probe.py [OUT_DIR] [--ladder | --ubench | --stage2 [--root DIR]
                          | --redesign [--sweep all|msm|fexp|miller|gtp|pairing|affine|add|fused]
                          [--parent DIR]]

Builds every CUDA source of the PyTorch port with `nvcc` and prints each
source's `ptxas -v` report. Then the window ladder of `g1_mul` and
`g2_mul` (`csrc/bn254_ladder.cuh`): both kernels against their plain
versions on edge rows (scalars 0, 1, r-1, all digits 15 below the top,
a point at infinity, coordinates in [p, 2p)), and the sweep of lanes a
row, TPI in {1, 2, 4, 8}: each kernel built once a TPI (`-DFTS_G1_MUL_TPI`,
`-DFTS_G2_MUL_TPI`, all builds started together), its ptxas line,
its output held against the built kernel's and its time by CUDA events
at the verify's rows (g1_mul 256, 4,096 and 7,936; g2_mul 496 and
7,936). With `--ladder` it stops there and writes the two kernels' SASS.
Otherwise it goes on and holds the range-path kernels (G1 and G2
to-affine, G2 add and ladder, Miller loop, final exponentiation, GT
product) against their plain torch versions on a few rows with the edge
cases (infinity, P+P, P-P, scalars 0, 1 and r-1, a (0, 0) Miller leg),
and times three of them once at about a block's rows. Then the mesh
plane: the fused pairing product's two modes (`csrc/pairing_fused.cu`)
against the staged kernels on K = 1, 2, 4 and against the plain version
with a masked leg, timed once beside the staged sequence, and
`sharded_pairing_product(fused=True)` on logical (2, 2) and (1, 1)
meshes with its launches. Then the prove
plane: the select multiexp against its plain version and the gather on
the scalar edges, its time on zero and on random scalars beside the
gather's, a small batched 2-in/2-out prove on the card checked by the
host verifier, a few PS signatures through `BatchedPSVerifier`, and the
select kernel's PTX and SASS written to OUT_DIR (default `probe_out/`,
git-ignored) with a count of
its loads, predicated loads and branches, beside the same counts for
`g1_mul` and `g2_mul`. It takes about two minutes
of command time where `chip_smoke.py` takes six or more: the place to
find a kernel that does not build or disagrees before the full smoke
run. With `--redesign` it instead checks `g1_msm` (both forms) and
`final_exp` against their plain versions on edge rows (tables and
values in [p, 2p) too), sweeps g1_msm's lanes a row S in {4, 8, 16, 32}
(`-DFTS_G1_MSM_S`) and final_exp's G in {1, 2, 4, 8, 16, 32}
(`-DFTS_FINAL_EXP_G`), each variant held against the built kernel and
timed at the verify's and the prove's rows, times `g1_mul`/`g2_mul`,
writes both kernels' SASS with the same counts, and stops. With
`--redesign --sweep miller` (or `gtp`) it checks `miller` (or
`gt_product` at K = 1-4) against its plain version on edge rows (a
(0, 0) leg, the generators, coordinates in [p, 2p)), builds the kernel
at every G in {1, 2, 4, 8, 16, 32} (`-DFTS_MILLER_G`,
`-DFTS_GT_PRODUCT_G`), holds each variant against the built kernel,
times it at the paths' rows (`miller` 128, 992 and 15,872 legs;
`gt_product` K = 4 at 248 and 3,968 rows, K = 2 at 256 and 4,096),
prints its ptxas line and the blocks an SM holds
(`fts_*_occupancy`), writes the kernel's SASS with the same counts, and
stops; `--sweep pairing` runs both of these, `--sweep all` every sweep.
With `--redesign --sweep add [--parent DIR]` it builds only
`g1_addsub.cu` and `g2_add.cu` (and DIR's, a checkout of another commit,
to time beside them): both against their plain versions on edge rows
(P + P, P - P, P + P with another Z, infinity as Z = 0 and Z = p on
either side and both, coordinates in [p, 2p)), `g1_addsub` as a sub and
as an add; each at TPI (G1) or G (G2) lanes a row and 32 or 128 threads
a block (`-DFTS_G1_ADDSUB_TPI`, `-DFTS_G2_ADD_G`, `_THREADS`), held
against the built kernel and timed by direct launches in two turns at
the paths' rows (G1 64, 256, 384, 4,096, 6,144; G2 64, 248, 384, 3,968,
6,144) beside an empty launch on the variant's grid; prints ptxas and
blocks an SM, writes both kernels' SASS and their branch, exit and
compare lines (`*.branches`), and stops.
With `--redesign --sweep affine` it checks `g1_to_affine` and
`g2_to_affine` against their plain versions on edge rows (Z = 0 and Z =
p, coordinates in [p, 2p), the generator), times each by direct
launches at the paths' rows (G1 744 and 11,904, G2 64, 248 and 3,968)
and at 65,536 (the host decode's scale) beside an empty launch on the
same grid (`csrc/probe_empty.cu`), prints their ptxas lines, blocks an
SM, SASS counts and every branch, exit and compare of their code, and
stops.
With `--redesign --sweep fused [--parent DIR]` it holds both modes of
`pairing_fused.cu` against the plain version and the staged kernels on
edge rows (K = 1-4, rows past a block's last, a (0, 0) leg unmasked and
masked, a finite leg masked, coordinates in [p, 2p)), builds it at every
variant of FUSED_VARIANTS (GM lanes a leg, GF lanes a row:
`-DFTS_FUSED_GM`, `_GF`) and DIR's source, holds each
against the built kernel and times both modes by direct launches in two
turns at FUSED_ROWS (the membership check's 248 / 3,968 x 4, the PS
verify's 64 / 4,096 x 2) beside the staged launches and an empty launch
on its grid, prints ptxas, the rows and shared memory a block and the
blocks an SM, times the mask kinds (none, one, all masked, (0, 0) legs)
in shuffled rounds, times the built kernel's two parts alone on its grid
(`csrc/probe_fused_parts.cu`: the Miller loops; the product and the final
exponentiation at the kernel's rows a warp) beside the staged kernels,
writes the SASS with each function's size beside `miller`'s,
`final_exp`'s and `gt_product`'s and the branch lines
(`pairing_fused.branches`), and stops.
With `--stage2 [--root DIR]` it times `sharded_pairing_product` as
`multichip_torch.py`'s stage 2 and `chip_smoke.py`'s mesh phase call it
(3 and 64 PS rows, the (1, 1) and the (2, 2) mesh, fused and staged) by
CUDA events and the host's clock, then `multichip_torch.py --logical
--devices 4 --mp 2` with and without `--fused`, all with the port of DIR
(a checkout, by default this one), and stops.
With `--ubench` it builds only `csrc/probe_fe2.cu` and prints its
micro-benchmarks (cycles of a dependent Fp2 product at one call site and
unrolled at 8 and 64 sites, of an Fp2 addition, and of shared-memory
loads at strides that meet in few or in all banks), from one warp to
32 warps an SM, and stops. Needs one NVIDIA GPU; imports
nothing of JAX.
"""
import argparse
import contextlib
import ctypes
import glob
import os
import random
import re
import subprocess
import sys
import time

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("out_dir", nargs="?", default="probe_out")
ap.add_argument("--ladder", action="store_true", help="stop after the ladder checks and sweep")
ap.add_argument("--redesign", action="store_true",
                help="g1_msm, final_exp, miller, gt_product: checks, the S and G sweeps, SASS; "
                     "then stop")
ap.add_argument("--sweep", choices=("all", "msm", "fexp", "miller", "gtp", "pairing", "affine",
                                    "add", "fused"),
                default="all",
                help="with --redesign: which kernel's variants to build and time")
ap.add_argument("--parent", default=None,
                help="with --sweep add or fused: a checkout of the parent commit whose "
                     "g1_addsub.cu and g2_add.cu, or pairing_fused.cu, are built and timed beside "
                     "the variants")
ap.add_argument("--ubench", action="store_true",
                help="build csrc/probe_fe2.cu, print its cycle counts, stop")
ap.add_argument("--stage2", action="store_true",
                help="time the mesh plane's fused pairing product as its dry runs call it, stop")
ap.add_argument("--root", default=None,
                help="with --stage2: the checkout whose port is imported (default: this one)")
args = ap.parse_args()
sys.path.insert(0, os.path.abspath(args.root) if args.root
                else os.path.dirname(os.path.abspath(__file__)))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from fabric_token_sdk_tpu_torch.crypto import hostmath as hm  # noqa: E402
from fabric_token_sdk_tpu_torch.ops import _build, curve as cv, curve2 as cv2  # noqa: E402
from fabric_token_sdk_tpu_torch.ops import limbs as lb  # noqa: E402
from fabric_token_sdk_tpu_torch.ops import pairing as pr, stages as st, tower as tw  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_probe.py needs an NVIDIA GPU")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, timeout=60)
print("device", torch.cuda.get_device_name(0), "| nvidia-smi:", smi.stdout.strip(), flush=True)
if args.ubench:
    try:
        fn = _build.build_probe("probe_fe2.cu").fts_probe_fe2
    finally:
        print("build probe_fe2.cu |", " | ".join(
            ln.strip() for ln in _build.BUILD_LOG.get("probe_fe2.cu", "").splitlines()
            if "Used" in ln or "stack" in ln or "error" in ln), flush=True)
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    words = torch.randint(0, 1 << 28, (128,), dtype=torch.int32, device=dev)  # below p
    out = torch.zeros(132 * 32 * 32 * 16, dtype=torch.int32, device=dev)
    cyc = torch.zeros(132 * 32, dtype=torch.int64, device=dev)
    n = 1024
    for which, what in ((0, "Fp2 product, one site"), (1, "Fp2 product, 8 sites"),
                        (2, "Fp2 product, 64 sites"), (3, "Fp2 addition")):
        for per_sm in (1, 4, 12, 32):
            blocks = 132 * per_sm
            fn(which, words.data_ptr(), out.data_ptr(), cyc.data_ptr(), n, blocks, 0)  # warm-up
            t = time.perf_counter()
            rc = fn(which, words.data_ptr(), out.data_ptr(), cyc.data_ptr(), n, blocks, 0)
            wall = time.perf_counter() - t
            c = cyc[:blocks].double() / n
            print(f"ubench {what}, {per_sm} warps an SM: rc {rc}, cycles an op (a warp) mean "
                  f"{c.mean().item():.1f} max {c.max().item():.1f}; wall {wall * 1e3:.3f} ms",
                  flush=True)
    for stride in (1, 16, 17, 64, 65):
        rc = fn(4, words.data_ptr(), out.data_ptr(), cyc.data_ptr(), n, 1, stride)
        print(f"ubench 16 dependent shared loads, lane stride {stride} words: rc {rc}, "
              f"{cyc[0].item() / n:.1f} cycles", flush=True)
    sys.exit(0)
ADD_ONLY = args.redesign and args.sweep == "add"  # builds only what its sweep times
t0 = time.perf_counter()
try:
    if not ADD_ONLY:
        _build.build_all()
finally:
    for src, log in sorted(_build.BUILD_LOG.items()):
        print("=====", src)
        print(log[-6000:])
print("build s", time.perf_counter() - t0, {src: round(sec, 1) for src, sec in sorted(
    _build.BUILD_SECONDS.items(), key=lambda x: -x[1])}, flush=True)
dev = torch.device("cuda")
rng = random.Random(3)
bad = []
out_dir = args.out_dir
os.makedirs(out_dir, exist_ok=True)


def chk(name, got, want):
    ok = torch.equal(got.cpu(), want.cpu())
    print(name, "OK" if ok else "MISMATCH", flush=True)
    if not ok:
        bad.append(name)


def stage2():
    """The mesh plane's fused pairing product as its dry runs call it:
    sharded_pairing_product on the (1, 1) and the (2, 2) mesh of this card,
    fused and staged, on PS rows (K = 2, every GT value one) at
    multichip_torch.py's stage-2 rows (3 on a (2, 2) mesh) and at
    chip_smoke.py's (64); ms a call by CUDA events and by the host's clock
    (mean of 5 after a warm-up); then multichip_torch.py --logical
    --devices 4 --mp 2, with and without --fused, whole, by the host's
    clock (mean of 3 after a warm-up). The port is the one of --root."""
    import multichip_torch
    from fabric_token_sdk_tpu_torch.crypto import pssign
    from fabric_token_sdk_tpu_torch.parallel import make_mesh, sharded_pairing_product

    print("stage2: the port of", os.path.dirname(os.path.abspath(multichip_torch.__file__)),
          flush=True)
    meshes = {"(1, 1)": make_mesh(1, devices=[dev]),
              "(2, 2)": make_mesh(4, mp=2, devices=[dev] * 4)}
    signer = pssign.keygen(1, rng)
    for b in (3, 64):
        msgs = [[rng.randrange(100)] for _ in range(b)]
        sigs = [signer.sign(m, rng) for m in msgs]
        Ps = torch.stack([torch.from_numpy(pr.encode_g1([hm.g1_neg(x.S), x.R]))
                          for x in sigs]).to(dev)
        Qs = torch.stack([torch.from_numpy(pr.encode_g2([signer.Q, signer.message_base(m)]))
                          for m in msgs]).to(dev)
        for name, mesh in meshes.items():
            for fused in (True, False):
                def call(mesh=mesh, fused=fused):
                    return sharded_pairing_product(Ps, Qs, mesh, fused=fused)

                if not pr.gt_is_one_host(call().cpu().numpy()).all():
                    bad.append(f"stage2 {b} rows {name} fused={fused}")
                ev = event_ms(call, 5)
                t = time.perf_counter()
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) / 5 * 1e3
                print(f"stage2 {b} PS rows, {name} mesh, {'fused' if fused else 'staged'}: "
                      f"{ev:.4f} ms by events, {wall:.4f} ms by the host's clock", flush=True)
    for flags in (["--fused"], []):
        argv = ["--logical", "--devices", "4", "--mp", "2", *flags]
        walls = []
        for _ in range(4):
            t = time.perf_counter()
            if multichip_torch.main(argv) != 0:
                bad.append(f"multichip_torch.py {' '.join(argv)}")
            walls.append(time.perf_counter() - t)
        print(f"stage2 multichip_torch.py {' '.join(argv)}: {sum(walls[1:]) / 3:.4f} s by the "
              f"host's clock ({'/'.join(f'{w:.4f}' for w in walls)}, the first a warm-up)",
              flush=True)


def ptxas_line(log, only=""):
    """The stack/spill and register lines of each entry function (those
    whose mangled name holds `only`)."""
    lines = log.splitlines()
    return " | ".join(" ".join(x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4])
                      for i, ln in enumerate(lines) if "Compiling entry function" in ln
                      and only in ln)


def lifted(words, rows):
    """Every 8-word value of the given rows moved from [0, p) into [p, 2p)."""
    out = words.clone()
    flat = out.view(out.shape[0], -1, lb.NWORDS)
    for r in rows:
        for c in range(flat.shape[1]):
            v = lb.words_to_int(flat[r, c].numpy())
            if v < hm.P:
                flat[r, c] = torch.from_numpy(lb.int_to_words(v + hm.P))
    return out


cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")


def write_sass(source, lib=None):
    path = os.path.join(out_dir, os.path.basename(lib or source).replace(".cu", ".sass")
                        .replace(".so", ".sass"))
    libs = [lib] if lib else glob.glob(os.path.join(_build.BUILD_DIR, source.replace(".cu", "-*.so")))
    if libs and os.path.exists(cuobjdump):
        with open(path, "w") as fh:
            subprocess.run([cuobjdump, "-sass", libs[0]], stdout=fh, stderr=subprocess.STDOUT,
                           check=False)
    return path


def code_summary(path, start_pat, pats):
    if not os.path.exists(path):
        print("no", path)
        return
    text = open(path).read()
    for m in re.finditer(start_pat, text):
        body = text[m.start():]
        nxt = re.search(start_pat, body[1:])
        body = body[: nxt.start() + 1] if nxt else body
        print(path, m.group(0)[:80], ", ".join(
            f"{what} {len(re.findall(pat, body))}" for what, pat in pats.items()), flush=True)


def branch_lines(path, kernel):
    """Print every branch, exit, predicated instruction and
    predicate-setting compare or logic of a kernel's function in a SASS
    file: what decides each branch and each predicated instruction."""
    if not os.path.exists(path):
        return
    text = open(path).read()
    m = re.search(r"Function : \S*" + kernel + r"\S*", text)
    if not m:
        print("no function", kernel, "in", path)
        return
    body = text[m.start():]
    nxt = re.search(r"Function : ", body[1:])
    body = body[: nxt.start() + 1] if nxt else body
    for ln in body.splitlines():
        if re.search(r"\b(?:BRA|EXIT|ISETP|PLOP3|BSSY|BSYNC)\b|@!?P\d", ln):
            print(f"  {kernel}:", ln.strip()[:120], flush=True)


SASS_PATS = {"LDG": r"\bLDG", "predicated LDG": r"@!?P\d\s+LDG", "LDS": r"\bLDS",
             "predicated LDS": r"@!?P\d\s+LDS", "BRA": r"\bBRA\b",
             "predicated BRA": r"@!?P\d\s+BRA", "SHFL": r"\bSHFL", "VOTE": r"\bVOTE"}


def build_jobs(jobs, only=""):
    """Run nvcc for every job (key, source, csrc, defines, lib) at once;
    returns {key: (lib path, ptxas line of the entries named `only`)} for
    the builds that passed."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = []
    for key, source, csrc, defines, lib in jobs:
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}",
               *(f"-D{k}={v}" for k, v in defines), "-o", lib, os.path.join(csrc, source)]
        procs.append((key, source, defines, lib, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {}
    for key, source, defines, lib, t_start, proc in procs:
        log, _ = proc.communicate()
        print(f"sweep build {source} {key}: rc {proc.returncode}, "
              f"{time.perf_counter() - t_start:.1f} s; ptxas {ptxas_line(log, only)}", flush=True)
        if proc.returncode != 0:
            print(log[-4000:])
            bad.append(f"build {source} {key}")
            continue
        built[key] = (lib, ptxas_line(log, only))
    return built


def build_variants(source, defines_list, only=""):
    """Build `source` once per set of -D flags, all nvcc processes at once;
    returns {defines: (lib path, ptxas line of the entries named `only`)}
    for the builds that passed."""
    jobs = []
    for defines in defines_list:
        tag = "-".join(f"{k.split('_')[-1]}{v}" for k, v in defines)
        lib = os.path.join(_build.BUILD_DIR, f"sweep-{source[:-3]}-{tag}.so")
        jobs.append((defines, source, _build.CSRC, defines, lib))
    return build_jobs(jobs, only)


def event_ms(call, reps):
    call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


if args.stage2:
    stage2()
    print("failed:", bad)
    sys.exit(1 if bad else 0)


def occupancy(lib, name):
    """Blocks of a kernel an SM holds at once (`fts_<name>_occupancy`)."""
    blocks = ctypes.c_int()
    fn = ctypes.CDLL(lib)[f"fts_{name}_occupancy"]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(blocks))
    return blocks.value if rc == 0 else f"error {rc}"


def affine_rows(curve, n, seed):
    """n Jacobian rows (G1 (n, 3, 8) or G2 (n, 3, 2, 8)) of random points
    with random Z, and the edges: the generator with Z = 1 (row 0), Z = 0
    (row 3) and Z = p (row 10, the redundant zero) inside the first warp,
    every coordinate lifted into [p, 2p) in rows 20-24."""
    r_ = random.Random(seed)
    P, RM = hm.P, (1 << 256) % hm.P
    g1_ = curve == "g1"
    gen = hm.G1_GEN if g1_ else hm.G2_GEN
    pts = [gen] + [(hm.g1_mul if g1_ else hm.g2_mul)(gen, r_.randrange(1, hm.R))
                   for _ in range(n - 1)]
    k = 3 if g1_ else 6
    w = np.zeros((n, k, lb.NWORDS), dtype=np.int32)
    for i, pt in enumerate(pts):
        if i == 3:
            continue
        if g1_:
            z = 1 if i == 0 else r_.randrange(1, P)
            w[i] = lb.ints_to_words([v * RM % P for v in (pt[0] * z * z, pt[1] * z ** 3, z)])
        else:
            z = (1, 0) if i == 0 else (r_.randrange(P), r_.randrange(P))
            zz = hm.fp2_mul(z, z)
            w[i] = tw.encode_fp2([hm.fp2_mul(pt[0], zz), hm.fp2_mul(pt[1], hm.fp2_mul(zz, z)),
                                  z]).reshape(k, lb.NWORDS)
    w[10, 2 * k // 3:] = lb.ints_to_words([P] * (k // 3))
    out = lifted(torch.from_numpy(w), range(20, min(25, n)))
    return out.reshape((n, 3, lb.NWORDS) if g1_ else (n, 3, 2, lb.NWORDS)).contiguous()


def add_operands(curve, n, seed):
    """n pairs of Jacobian rows (a, b) of random points with random Z
    (`affine_rows`: Z = 0 in row 3 and Z = p in row 10 of a, every
    coordinate in [p, 2p) in rows 20-24), and the edges of an add: b = a
    (P + P) in row 5, b = -a (P - P) in row 6, b = a with another Z (P + P
    again) in row 7, b at infinity in rows 12 and 3 (both at infinity in
    row 3), a and b lifted into [p, 2p) together in row 21."""
    a, b = affine_rows(curve, n, seed), affine_rows(curve, n, seed + 1)
    k = 3 if curve == "g1" else 6
    fa, fb = a.view(n, k, lb.NWORDS), b.view(n, k, lb.NWORDS)
    ints = [lb.words_to_int(fa[r, c].numpy()) for r in (6, 7) for c in range(k)]
    lam = 0x1234567 + seed
    for c in range(k):
        v6, v7 = ints[c], ints[k + c]
        if k // 3 <= c < 2 * k // 3:  # Y
            v6 = (hm.P - v6 % hm.P) % hm.P
        scale = lam ** (2 if c < k // 3 else 3 if c < 2 * k // 3 else 1)
        fb[6, c] = torch.from_numpy(lb.int_to_words(v6))
        fb[7, c] = torch.from_numpy(lb.int_to_words(v7 * scale % hm.P))
    fb[5] = fa[5]
    fb[21] = fa[21]
    fb[3] = fb[12] = 0
    return a.contiguous(), b.contiguous()


def add_sweep():
    """g1_addsub and g2_add: the built kernels against their plain versions
    on edge rows, both layouts built at each lane count and threads a
    block (and the parent's sources with --parent), each held against the
    built kernel and timed by direct launches at the paths' rows beside an
    empty launch on its grid; ptxas, blocks an SM, and the built kernels'
    SASS with every branch, exit and compare."""
    stream = torch.cuda.current_stream().cuda_stream
    empty = _build.build_probe("probe_empty.cu").fts_empty_launch
    empty.argtypes, empty.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    curves = {"g1": ("g1_addsub", "FTS_G1_ADDSUB", (64, 256, 384, 4096, 6144)),
              "g2": ("g2_add", "FTS_G2_ADD", (64, 248, 384, 3968, 6144))}
    jobs = []
    for curve, (name, macro, _) in curves.items():
        lanes_macro = "TPI" if curve == "g1" else "G"
        source = f"{name}.cu"
        jobs.append((("built",), source, _build.CSRC, (), _build._lib_path(source)))
        if args.parent:
            pdir = os.path.join(args.parent, "fabric_token_sdk_tpu_torch", "csrc")
            jobs.append((("parent",), source, pdir, (),
                         os.path.join(_build.BUILD_DIR, f"parent-{name}.so")))
        for lanes, threads in ADD_VARIANTS[curve]:
            defines = ((f"{macro}_{lanes_macro}", lanes), (f"{macro}_THREADS", threads))
            jobs.append(((lanes, threads), source, _build.CSRC, defines, os.path.join(
                _build.BUILD_DIR, f"sweep-{name}-{lanes}-{threads}.so")))
    built = {}
    for (source, key), v in build_jobs([((j[1], j[0]),) + j[1:] for j in jobs]).items():
        built.setdefault(source, {})[key] = v

    def config(lib, name):
        vals = [ctypes.c_int() for _ in range(2 if name == "g1_addsub" else 3)]
        fn = ctypes.CDLL(lib)[f"fts_{name}_config"]
        fn.restype = ctypes.c_int
        fn(*(ctypes.byref(v) for v in vals))
        return tuple(v.value for v in vals)

    summary = {}
    for curve, (name, _, path_rows) in curves.items():
        libs = built.get(f"{name}.cu", {})
        if ("built",) not in libs:
            continue
        entries = {}
        for key, (lib, p_) in libs.items():
            fn = ctypes.CDLL(lib)[f"fts_{name}"]
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (2 if curve == "g1" else 1) + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            if key == ("parent",):
                grid, blocks_sm = (1, 128 if curve == "g1" else 32), occupancy_or_none(lib, name)
            else:
                grid, blocks_sm = config(lib, name)[:2], occupancy(lib, name)
            entries[key] = (fn, p_, grid, blocks_sm)
            print(f"{name} {key}: ptxas {p_}; lanes, threads {grid}; blocks an SM {blocks_sm}",
                  flush=True)
        built_fn = entries[("built",)][0]

        def launch(fn, a, b, out, n_rows, negate_b=1):
            extra = (negate_b,) if curve == "g1" else ()  # g1: a - b (the verify's g1_sub)
            rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n_rows, *extra, stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        a, b = add_operands(curve, 61, 81)
        plain = (lambda x, y: st.g1_addsub_plain(x, y, True)) if curve == "g1" else st.g2_add_plain
        got = torch.empty_like(a).to(dev)
        launch(built_fn, a.to(dev), b.to(dev), got, a.shape[0])
        torch.cuda.synchronize()
        chk(f"{name} built kernel, edge rows (61) vs the plain version", got, plain(a, b))
        if curve == "g1":
            launch(built_fn, a.to(dev), b.to(dev), got, a.shape[0], 0)
            torch.cuda.synchronize()
            chk("g1_addsub as an add, edge rows vs the plain version", got,
                st.g1_addsub_plain(a, b, False))
        a, b = a.to(dev), b.to(dev)
        times = {key: {} for key in entries}
        floor = {}
        for n_rows in path_rows:
            idx = torch.arange(n_rows, device=dev) % a.shape[0]
            x, y = a[idx].contiguous(), b[idx].contiguous()
            want = torch.empty_like(x)
            launch(built_fn, x, y, want, n_rows)
            outs = {}
            for key, (fn, _, _, _) in entries.items():
                outs[key] = torch.empty_like(x)
                launch(fn, x, y, outs[key], n_rows)
            torch.cuda.synchronize()
            for key in entries:
                if key != ("built",):
                    chk(f"{name} {key} {n_rows} rows vs the built kernel", outs[key], want)
            for turn, order in enumerate((list(entries), list(entries)[::-1])):
                for key in order:
                    fn, _, (lanes, threads), _ = entries[key]
                    ms = event_ms(lambda: launch(fn, x, y, outs[key], n_rows), 200)
                    times[key].setdefault(n_rows, []).append(ms)
                    blocks = -(-n_rows * lanes // threads)
                    if (blocks, threads) not in floor:
                        floor[(blocks, threads)] = event_ms(lambda: empty(blocks, threads, stream), 200)
        print(f"{name}: ms by direct launches (mean of two turns) at rows {path_rows}; the empty "
              f"launch on the variant's grid beside it", flush=True)
        for key, (_, p_, (lanes, threads), blocks_sm) in entries.items():
            ms = {r: sum(t) / len(t) for r, t in times[key].items()}
            empty_ms = [floor[(-(-r * lanes // threads), threads)] for r in path_rows]
            summary[(name, key)] = sum(ms.values())
            print(f"  {name} {key}: " + ", ".join(
                f"{r} {ms[r]:.4f} (turns {'/'.join(f'{t:.4f}' for t in times[key][r])}, empty "
                f"{e:.4f})" for r, e in zip(path_rows, empty_ms))
                + f"; sum {sum(ms.values()):.4f}; ptxas {p_}; blocks an SM {blocks_sm}", flush=True)
        ranked = sorted((v, key) for (n_, key), v in summary.items()
                        if n_ == name and key not in (("built",), ("parent",)))
        if ranked:
            print(f"{name}: least sum {ranked[0][1]} {ranked[0][0]:.4f} ms; next "
                  + ", ".join(f"{k} {v:.4f}" for v, k in ranked[1:4]), flush=True)
        sass = write_sass(f"{name}.cu", _build._lib_path(f"{name}.cu"))
        code_summary(sass, r"Function : \S+", {**SASS_PATS, "LDL/STL": r"\b(?:LDL|STL)",
                                               "EXIT": r"\bEXIT", "predicated": r"@!?P\d"})
        with open(os.path.join(out_dir, f"{name}.branches"), "w") as fh, \
                contextlib.redirect_stdout(fh):
            branch_lines(sass, f"{name}_kernel")


def occupancy_or_none(lib, name):
    try:
        return occupancy(lib, name)
    except AttributeError:  # the parent's sources export no occupancy entry
        return None


# (lanes a row, threads a block) of add_sweep: g1_addsub splits each
# element over TPI lanes, g2_add the formula's base products over G
ADD_VARIANTS = {"g1": tuple((tpi, t) for t in (32, 128) for tpi in (2, 4, 8)),
                "g2": tuple((g, t) for t in (32, 128) for g in (4, 8, 16, 32))}
if args.redesign and args.sweep in ("all", "add"):
    add_sweep()
    if args.sweep != "all":
        print("failed:", bad)
        sys.exit(1 if bad else 0)

# (lanes a leg GM, lanes a row GF) of fused_sweep, and its row sets: the
# membership check's (K = 4) and the PS verify's (K = 2) at a block's and a
# batch's rows
FUSED_VARIANTS = tuple((gm, gf) for gm in (2, 4, 8) for gf in (4, 8, 16))
FUSED_ROWS = ((248, 4), (3968, 4), (64, 2), (4096, 2))
FUSED_MASK_ROUNDS = 8


def fused_sweep():
    """pairing_fused.cu, both modes: the built kernel against the plain
    version and the staged kernels on edge rows (K = 1-4, rows past a
    block's last, a (0, 0) leg unmasked and masked, a finite leg masked,
    coordinates in [p, 2p)); every variant (GM, GF) and the parent's
    source (--parent) held against the built kernel and timed by direct
    launches in two turns at FUSED_ROWS beside the staged launches and an
    empty launch on its grid; ptxas, shared memory and blocks an SM; the
    mask kinds in shuffled rounds; the built kernel's SASS with its size and
    every branch, exit and compare."""
    stream = torch.cuda.current_stream().cuda_stream
    empty = _build.build_probe("probe_empty.cu").fts_empty_launch
    empty.argtypes, empty.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    jobs = []
    if args.parent:
        pdir = os.path.join(args.parent, "fabric_token_sdk_tpu_torch", "csrc")
        jobs.append((("parent",), "pairing_fused.cu", pdir, (),
                     os.path.join(_build.BUILD_DIR, "parent-pairing_fused.so")))
    for gm, gf in FUSED_VARIANTS:
        defines = (("FTS_FUSED_GM", gm), ("FTS_FUSED_GF", gf))
        jobs.append(((gm, gf), "pairing_fused.cu", _build.CSRC, defines, os.path.join(
            _build.BUILD_DIR, f"sweep-pairing_fused-{gm}-{gf}.so")))
    jobs.append((("parts",), "probe_fused_parts.cu", _build.CSRC, (),
                 os.path.join(_build.BUILD_DIR, "probe-fused-parts.so")))
    libs = {("built",): (_build._lib_path("pairing_fused.cu"),
                         ptxas_line(_build.BUILD_LOG.get("pairing_fused.cu", "")))}
    libs.update(build_jobs(jobs))
    parts_lib = libs.pop(("parts",), None)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    entries = {}
    for key, (lib, p_) in libs.items():
        L = ctypes.CDLL(lib)
        prod, tail = L.fts_pairing_product, L.fts_gt_product_final_exp
        prod.argtypes, prod.restype = [P_] * 4 + [I_, I_, P_], I_
        tail.argtypes, tail.restype = [P_] * 2 + [I_, I_, P_], I_
        cfg, occ = {}, {}
        if key != ("parent",):
            for k in (2, 4):
                vals, blocks = (ctypes.c_int * 6)(), (ctypes.c_int * 2)()
                L.fts_pairing_fused_config(k, vals)
                rc = L.fts_pairing_fused_occupancy(k, blocks)
                cfg[k], occ[k] = tuple(vals), (tuple(blocks) if rc == 0 else f"error {rc}")
        entries[key] = (prod, tail, p_, cfg, occ)
        print(f"pairing_fused {key}: ptxas {p_}; " + "; ".join(
            f"K={k}: GM, GF {c[:2]}, rows/smem a warp {c[2]}/{c[3]} B (tail {c[4]}/"
            f"{c[5]} B), warps an SM {occ[k]}" for k, c in cfg.items()), flush=True)

    def grid_of(key, mode, n, k):
        """(blocks, threads a block) of a launch: fts_pairing_product_grid,
        else one warp a block (the tail; the parent's one thread a row)."""
        _, _, _, cfg, _ = entries[key]
        if mode == "product" and cfg:
            grid = (ctypes.c_int * 2)()
            ctypes.CDLL(libs[key][0]).fts_pairing_product_grid(n, k, grid)
            return tuple(grid)
        return (-(-n // (cfg[k][4] if cfg else 32)), 32)

    def run(fn_pair, mode, P, Q, mask, f, out, n, k):
        prod, tail = fn_pair
        if mode == "product":
            rc = prod(P.data_ptr(), Q.data_ptr(), 0 if mask is None else mask.data_ptr(),
                      out.data_ptr(), n, k, stream)
        else:
            rc = tail(f.data_ptr(), out.data_ptr(), n, k, stream)
        if rc:
            raise RuntimeError(f"pairing_fused {mode}: CUDA error {rc}")

    def staged(P, Q, mask):
        n, k = P.shape[0], P.shape[1]
        f = st.miller_rows(P.reshape(n * k, 2, 8), Q.reshape(n * k, 2, 2, 8))
        return st._mask_one(f.reshape(n, k, 6, 2, 8), mask).contiguous()

    # edge rows: 5 rows a K (rows past a block's last), leg 0 of row 1 (0, 0),
    # rows 2-3 lifted into [p, 2p); masked: that leg and the last leg of row 4
    g1p = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(12)]
    g2p = [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(12)]
    poolP, poolQ = torch.from_numpy(pr.encode_g1(g1p)), torch.from_numpy(pr.encode_g2(g2p))
    n_e, edge, plain_in = 5, {}, []
    for k in (1, 2, 3, 4):
        idx = torch.tensor([rng.randrange(12) for _ in range(n_e * k)])
        eP, eQ = poolP[idx].clone(), poolQ[idx].clone()
        eP[k] = 0  # row 1, leg 0: the (0, 0) leg
        eP = lifted(eP, range(2 * k, 4 * k))
        eQ = lifted(eQ, range(2 * k, 4 * k))
        mask = torch.zeros((n_e, k), dtype=torch.uint8)
        mask[1, 0] = mask[4, k - 1] = 1
        edge[k] = (eP.reshape(n_e, k, 2, 8), eQ.reshape(n_e, k, 2, 2, 8), mask)
        plain_in.append((eP, eQ))
    # the plain results of every group by one plain Miller call and one plain
    # final exponentiation
    f_plain = st.miller_plain(torch.cat([a for a, _ in plain_in]), torch.cat([b for _, b in plain_in]))
    prods, at = [], 0
    for k, (_, _, mask) in edge.items():
        fk = f_plain[at:at + n_e * k].reshape(n_e, k, 6, 2, 8)
        at += n_e * k
        prods += [st.gt_product_plain(fk), st.gt_product_plain(st._mask_one(fk, mask.bool().numpy()))]
    gt_plain = st.final_exp_plain(torch.cat(prods))
    at = 0
    for k, (eP, eQ, mask) in edge.items():
        for mtag, m in (("", None), (" masked", mask)):
            want = gt_plain[at:at + n_e]
            at += n_e
            dP, dQ = eP.contiguous().to(dev), eQ.contiguous().to(dev)
            dm = None if m is None else m.to(dev)
            f = staged(dP, dQ, None if m is None else m.bool().cpu().numpy())
            chk(f"fused edges K={k}{mtag}: staged kernels vs plain", st.final_exp_rows(
                st.gt_product_rows(f)), want)
            for key, (prod, tail, _, _, _) in entries.items():
                for mode in ("product", "tail"):
                    out = torch.empty((n_e, 6, 2, 8), dtype=torch.int32, device=dev)
                    run((prod, tail), mode, dP, dQ, dm, f, out, n_e, k)
                    torch.cuda.synchronize()
                    chk(f"fused edges {key} {mode} K={k}{mtag} vs plain", out, want)
    # the row sets: random legs from the pool, each variant against the staged
    # launches, then timed in two turns by direct launches
    times, floor, staged_ms, row_sets = {}, {}, {}, {}
    for n, k in FUSED_ROWS:
        idx = torch.tensor([rng.randrange(12) for _ in range(n * k)])
        P = poolP[idx].reshape(n, k, 2, 8).contiguous().to(dev)
        Q = poolQ[idx].reshape(n, k, 2, 2, 8).contiguous().to(dev)
        f = staged(P, Q, None)
        want = st.final_exp_rows(st.gt_product_rows(f))
        row_sets[(n, k)] = (P, Q, f, want)
        outs = {}
        for key, (prod, tail, _, _, _) in entries.items():
            for mode in ("product", "tail"):
                outs[(key, mode)] = torch.empty_like(want)
                run((prod, tail), mode, P, Q, None, f, outs[(key, mode)], n, k)
        torch.cuda.synchronize()
        for (key, mode), out in outs.items():
            chk(f"fused {key} {mode} {n}x{k} vs the staged kernels", out, want)
        staged_ms[(n, k)] = (event_ms(lambda: st.final_exp_rows(st.gt_product_rows(staged(
            P, Q, None))), 3), event_ms(lambda: st.final_exp_rows(st.gt_product_rows(f)), 5))
        for turn, order in enumerate((list(entries), list(entries)[::-1])):
            for key in order:
                prod, tail, _, cfg, _ = entries[key]
                for mode, reps in (("product", 3), ("tail", 5)):
                    out = outs[(key, mode)]
                    ms = event_ms(lambda: run((prod, tail), mode, P, Q, None, f, out, n, k), reps)
                    times.setdefault((key, mode, n, k), []).append(ms)
                    g = grid_of(key, mode, n, k)
                    if g not in floor:
                        floor[g] = event_ms(lambda: empty(g[0], g[1], stream), 50)
    print("fused: ms by direct launches (mean of two turns) at rows x K " + ", ".join(
        f"{n}x{k}" for n, k in FUSED_ROWS) + "; staged miller+gt_product+final_exp / "
        "gt_product+final_exp " + ", ".join(f"{n}x{k} {a:.4f}/{b:.4f}" for (n, k), (a, b)
                                            in staged_ms.items()), flush=True)
    sums = {}
    for key, (_, _, p_, cfg, occ) in entries.items():
        for mode in ("product", "tail"):
            ms = {(n, k): sum(t) / len(t) for (k_, m_, n, k), t in times.items()
                  if k_ == key and m_ == mode}
            sums[(key, mode)] = sum(ms.values())
            print(f"  {key} {mode}: " + ", ".join(
                f"{n}x{k} {v:.4f} (turns {'/'.join(f'{t:.4f}' for t in times[(key, mode, n, k)])}, "
                f"empty {floor[grid_of(key, mode, n, k)]:.4f})"
                for (n, k), v in ms.items()) + f"; sum {sums[(key, mode)]:.4f}", flush=True)
    for mode in ("product", "tail"):
        ranked = sorted((v, key) for (key, m_), v in sums.items()
                        if m_ == mode and key not in (("built",), ("parent",)))
        print(f"fused {mode}: least sum {ranked[0][1]} {ranked[0][0]:.4f} ms; next "
              + ", ".join(f"{k_} {v:.4f}" for v, k_ in ranked[1:4]), flush=True)
    # the built kernel's two parts, each alone on its grid (probe_fused_parts.cu),
    # beside the kernel, the staged miller and gt_product + final_exp, and the
    # tail, in two turns
    if parts_lib is not None:
        part = ctypes.CDLL(parts_lib[0]).fts_probe_fused_part
        part.argtypes, part.restype = [I_] + [P_] * 4 + [I_, I_, P_], I_
        prod, tail = entries[("built",)][:2]
        for (n, k), (P, Q, f, want) in row_sets.items():
            out, words = torch.empty_like(want), torch.empty(n, dtype=torch.int32, device=dev)

            def go(which, P=P, Q=Q, f=f, out=out, words=words, n=n, k=k):
                rc = part(which, P.data_ptr(), Q.data_ptr(), f.data_ptr(),
                          (words if which == 0 else out).data_ptr(), n, k, stream)
                if rc:
                    raise RuntimeError(f"probe_fused_parts part {which}: CUDA error {rc}")

            go(1)
            torch.cuda.synchronize()
            chk(f"fused exponentiation part {n}x{k} vs the staged kernels", out, want)
            calls = {
                "pairing_product": lambda: run((prod, tail), "product", P, Q, None, f, out, n, k),
                "Miller part": lambda: go(0),
                "exponentiation part": lambda: go(1),
                "staged miller": lambda: st.miller_rows(P.reshape(n * k, 2, 8),
                                                        Q.reshape(n * k, 2, 2, 8)),
                "staged gt_product+final_exp": lambda: st.final_exp_rows(st.gt_product_rows(f)),
                "tail": lambda: run((prod, tail), "tail", P, Q, None, f, out, n, k)}
            part_ms = {}
            for order in (list(calls), list(calls)[::-1]):
                for name in order:
                    part_ms.setdefault(name, []).append(event_ms(calls[name], 3))
            print(f"fused parts {n}x{k} (built, grid {grid_of(('built',), 'product', n, k)}): "
                  + ", ".join(f"{name} {sum(v) / 2:.4f} ({'/'.join(f'{t:.4f}' for t in v)})"
                              for name, v in part_ms.items()) + " ms", flush=True)
    # the mask kinds on the built kernel at the membership batch's rows, in
    # shuffled rounds: none masked, one leg a row masked, all masked, (0, 0)
    # legs unmasked
    n, k = 3968, 4
    idx = torch.tensor([rng.randrange(12) for _ in range(n * k)])
    P = poolP[idx].reshape(n, k, 2, 8).contiguous().to(dev)
    Q = poolQ[idx].reshape(n, k, 2, 2, 8).contiguous().to(dev)
    one = torch.zeros((n, k), dtype=torch.uint8)
    one[:, 1] = 1
    kinds = {"none masked": (P, torch.zeros((n, k), dtype=torch.uint8)),
             "one masked": (P, one), "all masked": (P, torch.ones((n, k), dtype=torch.uint8)),
             "(0, 0) legs": (torch.zeros_like(P), torch.zeros((n, k), dtype=torch.uint8))}
    prod, tail = entries[("built",)][:2]
    out = torch.empty((n, 6, 2, 8), dtype=torch.int32, device=dev)
    for kind, (kP, km) in kinds.items():
        want = st.final_exp_rows(st.gt_product_rows(staged(kP, Q, km.bool().numpy())))
        run((prod, tail), "product", kP, Q, km.to(dev), None, out, n, k)
        torch.cuda.synchronize()
        chk(f"fused built {kind} {n}x{k} vs the staged kernels", out, want)
    dev_masks = {kind: (kP, km.to(dev)) for kind, (kP, km) in kinds.items()}
    kind_ms = {kind: [] for kind in kinds}
    order = list(kinds)
    for _ in range(FUSED_MASK_ROUNDS):
        rng.shuffle(order)
        for kind in order:
            kP, km = dev_masks[kind]
            kind_ms[kind].append(event_ms(lambda: run((prod, tail), "product", kP, Q, km, None, out,
                                                      n, k), 3))
    means = {kind: sum(v) / len(v) for kind, v in kind_ms.items()}
    turns = max((max(v) - min(v)) / min(v) for v in kind_ms.values())
    print(f"fused mask kinds {n}x{k}, {FUSED_MASK_ROUNDS} shuffled rounds: " + ", ".join(
        f"{kind} {v:.4f}" for kind, v in means.items())
        + f" ms; spread between kinds {100 * (max(means.values()) / min(means.values()) - 1):.2f}%, "
        f"between turns of one kind up to {100 * turns:.2f}%", flush=True)
    pats = {**SASS_PATS, "LDL/STL": r"\b(?:LDL|STL)", "EXIT": r"\bEXIT", "predicated": r"@!?P\d",
            "instructions": r"/\*[0-9a-f]{4,}\*/ "}
    sass = write_sass("pairing_fused.cu", _build._lib_path("pairing_fused.cu"))
    code_summary(sass, r"Function : \S+", pats)
    for source in ("miller.cu", "final_exp.cu", "gt_product.cu"):
        code_summary(write_sass(source, _build._lib_path(source)), r"Function : \S+", pats)
    with open(os.path.join(out_dir, "pairing_fused.branches"), "w") as fh, \
            contextlib.redirect_stdout(fh):
        for kernel in ("pairing_product_kernel", "gt_product_final_exp_kernel"):
            branch_lines(sass, kernel)


if args.redesign and args.sweep in ("all", "fused"):
    fused_sweep()
    if args.sweep != "all":
        print("failed:", bad)
        sys.exit(1 if bad else 0)

if args.redesign and args.sweep in ("all", "affine"):
    # ------------------------------------------------------------ g1_to_affine and g2_to_affine
    # the built kernels against their plain versions on edge rows (Z = 0 and
    # p, Z in [p, 2p), the generator), timed by direct launches at the
    # paths' rows and at 65,536 (the host decode's scale) beside an empty
    # launch on the same grid (csrc/probe_empty.cu); ptxas, blocks an SM,
    # and the kernels' SASS with their branch lines
    stream = torch.cuda.current_stream().cuda_stream
    path_rows = {"g1": (744, 11904), "g2": (64, 248, 3968)}  # 2/2 verify; PS, prove/verify
    empty = _build.build_probe("probe_empty.cu").fts_empty_launch
    empty.argtypes, empty.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    affine_ms, floor_ms = {}, {}
    for curve in ("g1", "g2"):
        name = f"{curve}_to_affine"
        kernel = _build.G1_TO_AFFINE if curve == "g1" else _build.G2_TO_AFFINE
        rows_fn, plain_fn = getattr(st, f"{name}_rows"), getattr(st, f"{name}_plain")
        built = _build._lib_path(f"{name}.cu")
        print(f"ptxas {name}.cu:", ptxas_line(_build.BUILD_LOG.get(f"{name}.cu", "")),
              "| blocks an SM", occupancy(built, name), flush=True)
        edge = affine_rows(curve, 37, 71)
        chk(f"{name} edges (37 rows)", rows_fn(edge.to(dev)), plain_fn(edge))
        pool = affine_rows(curve, 61, 72).to(dev)
        for n_rows in path_rows[curve] + (65536,):
            x = pool[torch.arange(n_rows, device=dev) % pool.shape[0]].contiguous()
            out = rows_fn(x)
            if n_rows == path_rows[curve][-1]:
                chk(f"{name} {n_rows} rows vs the plain version", out, plain_fn(x))
            floor_ms[(curve, n_rows)] = event_ms(lambda: empty(-(-n_rows // 32), 32, stream), 50)
            affine_ms[(name, n_rows)] = event_ms(
                lambda: kernel.launch(dev, x.data_ptr(), out.data_ptr(), n_rows), 20)
            print(f"{name} {n_rows} rows: {affine_ms[(name, n_rows)]:.4f} ms "
                  f"(empty launch {floor_ms[(curve, n_rows)]:.4f})", flush=True)
        sass = write_sass(f"{name}.cu")
        code_summary(sass, r"Function : \S+", {**SASS_PATS, "LDL/STL": r"\b(?:LDL|STL)",
                                               "EXIT": r"\bEXIT", "predicated": r"@!?P\d"})
        branch_lines(sass, f"{name}_kernel")
    print("affine ms", {f"{t} {r}": round(v, 4) for (t, r), v in affine_ms.items()}, flush=True)
    print("empty launch ms", {f"{c} {r}": round(v, 4) for (c, r), v in floor_ms.items()}, flush=True)
    if args.sweep != "all":
        print("failed:", bad)
        sys.exit(1 if bad else 0)

if args.redesign and args.sweep in ("all", "miller", "gtp", "pairing"):
    # ------------------------------------------------------------ miller and gt_product
    # the built kernels against their plain versions on edge rows, then the
    # sweep over G lanes a row, each variant held against the built kernel
    built_lib = {s_: glob.glob(os.path.join(_build.BUILD_DIR, s_.replace(".cu", "-*.so")))[0]
                 for s_ in ("miller.cu", "gt_product.cu")}
    stream = torch.cuda.current_stream().cuda_stream
    sweep_ms, sweep_ptxas = {}, {}
    if args.sweep in ("all", "miller", "pairing"):
        print("ptxas miller.cu:", ptxas_line(_build.BUILD_LOG.get("miller.cu", "")),
              "| blocks an SM", occupancy(built_lib["miller.cu"], "miller"), flush=True)
        g1s = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(4)]
        g2s = [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(4)]
        mP = lifted(torch.from_numpy(pr.encode_g1(g1s + [None, hm.G1_GEN])), [1, 3])
        mQ = lifted(torch.from_numpy(pr.encode_g2(g2s + [g2s[0], hm.G2_GEN])), [2, 3])
        chk("miller edges", st.miller_rows(mP.to(dev), mQ.to(dev)), st.miller_plain(mP, mQ))
        g_mil = build_variants("miller.cu", [(("FTS_MILLER_G", g_),) for g_ in (1, 2, 4, 8, 16, 32)])
        for legs in (128, 992, 15872):
            idx = torch.arange(legs) % mP.shape[0]
            lP, lQ = mP[idx].contiguous().to(dev), mQ[idx].contiguous().to(dev)
            want = st.miller_rows(lP, lQ)
            for defines, (lib, p_) in g_mil.items():
                fn = ctypes.CDLL(lib)["fts_miller"]
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                out = torch.empty_like(want)

                def call():
                    rc = fn(lP.data_ptr(), lQ.data_ptr(), out.data_ptr(), legs, stream)
                    if rc:
                        raise RuntimeError(f"miller {defines}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                chk(f"sweep miller {dict(defines)} {legs} legs vs the built kernel", out, want)
                key = f"miller {legs} G={defines[0][1]}"
                sweep_ms[key] = event_ms(call, 3)
                sweep_ptxas[f"miller G={defines[0][1]}"] = (p_, occupancy(lib, "miller"))
                print(f"sweep {key}: {sweep_ms[key]:.4f} ms", flush=True)
        code_summary(write_sass("miller.cu"), r"Function : \S+", SASS_PATS)
    if args.sweep in ("all", "gtp", "pairing"):
        print("ptxas gt_product.cu:", ptxas_line(_build.BUILD_LOG.get("gt_product.cu", "")),
              "| blocks an SM", occupancy(built_lib["gt_product.cu"], "gt_product"), flush=True)
        vals = [tuple((rng.randrange(hm.P), rng.randrange(hm.P)) for _ in range(6))
                for _ in range(16)]
        fw = lifted(torch.from_numpy(tw.encode_fp12(vals)), range(0, 16, 3))
        for k in (1, 2, 3, 4):
            fk = fw[: 4 * k].reshape(4, k, 6, 2, 8).contiguous()
            chk(f"gt_product K={k} edges", st.gt_product_rows(fk.to(dev)), st.gt_product_plain(fk))
        g_gtp = build_variants("gt_product.cu",
                               [(("FTS_GT_PRODUCT_G", g_),) for g_ in (1, 2, 4, 8, 16, 32)])
        for k, n_rows in ((4, 248), (4, 3968), (2, 256), (2, 4096)):
            idx = torch.arange(n_rows * k) % fw.shape[0]
            fr = fw[idx].reshape(n_rows, k, 6, 2, 8).contiguous().to(dev)
            want = st.gt_product_rows(fr)
            for defines, (lib, p_) in g_gtp.items():
                fn = ctypes.CDLL(lib)["fts_gt_product"]
                fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                out = torch.empty_like(want)

                def call():
                    rc = fn(fr.data_ptr(), out.data_ptr(), n_rows, k, stream)
                    if rc:
                        raise RuntimeError(f"gt_product {defines}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                chk(f"sweep gt_product {dict(defines)} K={k} {n_rows} rows vs the built kernel",
                    out, want)
                key = f"gt_product K={k} {n_rows} G={defines[0][1]}"
                sweep_ms[key] = event_ms(call, 20)
                sweep_ptxas[f"gt_product G={defines[0][1]}"] = (p_, occupancy(lib, "gt_product"))
                print(f"sweep {key}: {sweep_ms[key]:.4f} ms", flush=True)
        code_summary(write_sass("gt_product.cu"), r"Function : \S+", SASS_PATS)
    print("sweep ms", {k: round(v, 4) for k, v in sweep_ms.items()}, flush=True)
    print("sweep ptxas, blocks an SM", sweep_ptxas, flush=True)
    if args.sweep != "all":
        print("failed:", bad)
        sys.exit(1 if bad else 0)

if args.redesign:
    # ------------------------------------------------------------ g1_msm and final_exp
    # the built kernels against their plain versions on edge rows, then the
    # sweeps: g1_msm over S lanes a row, final_exp over G lanes a row,
    # each variant held against the built kernel
    # (g1_msm as affine points: another split gives another Jacobian Z)
    print("ptxas g1_msm.cu:", ptxas_line(_build.BUILD_LOG.get("g1_msm.cu", "")), flush=True)
    print("ptxas final_exp.cu:", ptxas_line(_build.BUILD_LOG.get("final_exp.cu", "")), flush=True)
    bases = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(3)]
    tables = {nb: cv.FixedBaseTable(bases[:nb]).to(dev) for nb in (1, 2, 3)}
    edges = [0, 1, hm.R - 1, (1 << 256) - 1, 9 << 84, int("fedcba9876543210" * 4, 16)]
    for nb in (1, 2, 3):
        rows = [[k] * nb for k in edges] + [[rng.randrange(hm.R) for _ in range(nb)]
                                            for _ in range(10)]
        rows[-1][0] = 0
        sc = torch.from_numpy(lb.ints_to_words([x for r in rows for x in r]).reshape(len(rows), nb, 8))
        tab = tables[nb].table
        lifted_tab = lifted(tab.cpu().reshape(-1, 3, 8), range(0, tab.shape[0] * 16, 5)).reshape(
            tab.shape).to(dev)
        for name, fn, plain in (("g1_msm", st.g1_msm_rows, st.g1_msm_plain),
                                ("g1_msm_select", st.g1_msm_select_rows, st.g1_msm_select_plain)):
            for tag, t_ in (("", tab), (" table in [p, 2p)", lifted_tab)):
                got = fn(t_, sc.to(dev))
                chk(f"{name} nbases={nb}{tag} edges", got, plain(t_.cpu(), sc))
                if not tag:
                    host = [hm.g1_multiexp(bases[:nb], [x % hm.R for x in r]) for r in rows]
                    print(f"{name} nbases={nb} hostmath", cv.decode_points(got.cpu()) == host)
    fvals = [tuple((rng.randrange(hm.P), rng.randrange(hm.P)) for _ in range(6)) for _ in range(30)]
    fvals[0] = hm.fp12_from_int(1)
    fw = lifted(torch.from_numpy(tw.encode_fp12(fvals)), range(1, 30, 3))
    chk("final_exp edges", st.final_exp_rows(fw.to(dev)), st.final_exp_plain(fw))

    g_msm = {} if args.sweep == "fexp" else build_variants(
        "g1_msm.cu", [(("FTS_G1_MSM_S", s_),) for s_ in (4, 8, 16, 32)])
    g_fexp = {} if args.sweep == "msm" else build_variants(
        "final_exp.cu", [(("FTS_FINAL_EXP_G", g_),) for g_ in (1, 2, 4, 8, 16, 32)])
    stream = torch.cuda.current_stream().cuda_stream
    msm_cases = [("gather", 256, 3), ("gather", 4096, 3), ("gather", 3968, 1), ("gather", 3968, 2),
                 ("gather", 1984, 3), ("select", 384, 3), ("select", 6144, 3)]
    msm_sweep = {}
    for mode, n_rows, nb in msm_cases:
        ks = [rng.randrange(hm.R) for _ in range(n_rows * nb)]
        sc = torch.from_numpy(cv.encode_scalars(ks).reshape(n_rows, nb, 8)).to(dev)
        tab = tables[nb].table
        want = (st.g1_msm_rows if mode == "gather" else st.g1_msm_select_rows)(tab, sc)
        want_aff = st.g1_to_affine_rows(want)
        for defines, (lib, _) in g_msm.items():
            fn = ctypes.CDLL(lib)["fts_g1_msm" if mode == "gather" else "fts_g1_msm_select"]
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out = torch.empty_like(want)

            def call():
                rc = fn(tab.data_ptr(), sc.data_ptr(), out.data_ptr(), n_rows, nb, stream)
                if rc:
                    raise RuntimeError(f"g1_msm {defines}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            chk(f"sweep g1_msm {mode} {dict(defines)} {n_rows}x{nb} vs the built kernel (affine)",
                st.g1_to_affine_rows(out), want_aff)
            msm_sweep[(mode, n_rows, nb, defines)] = event_ms(call, 10)
            print(f"sweep g1_msm {mode} S={defines[0][1]} {n_rows}x{nb}: "
                  f"{msm_sweep[(mode, n_rows, nb, defines)]:.4f} ms", flush=True)
    fexp_sweep = {}
    for n_rows in (248, 3968):
        fr = torch.from_numpy(tw.encode_fp12(
            [fvals[i % len(fvals)] for i in range(n_rows)])).to(dev)
        want = st.final_exp_rows(fr)
        for defines, (lib, _) in g_fexp.items():
            fn = ctypes.CDLL(lib)["fts_final_exp"]
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out = torch.empty_like(want)

            def call():
                rc = fn(fr.data_ptr(), out.data_ptr(), n_rows, stream)
                if rc:
                    raise RuntimeError(f"final_exp {defines}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            chk(f"sweep final_exp {dict(defines)} {n_rows} rows vs the built kernel", out, want)
            fexp_sweep[(n_rows, defines)] = event_ms(call, 3)
            print(f"sweep final_exp G={defines[0][1]} {n_rows} rows: "
                  f"{fexp_sweep[(n_rows, defines)]:.4f} ms", flush=True)
    print("sweep g1_msm ms", {f"{m} {r}x{b} S={d[0][1]}": round(v, 4)
                              for (m, r, b, d), v in msm_sweep.items()}, flush=True)
    print("sweep g1_msm ptxas", {f"S={d[0][1]}": p_ for d, (_, p_) in g_msm.items()})
    print("sweep final_exp ms", {f"{r} G={d[0][1]}": round(v, 4)
                                 for (r, d), v in fexp_sweep.items()}, flush=True)
    print("sweep final_exp ptxas", {f"G={d[0][1]}": p_ for d, (_, p_) in g_fexp.items()})
    # the ladders over the same cooperative field, at the verify's rows
    for name, fn, enc, gen, n_rows in (
            ("g1_mul", st.g1_mul_rows, cv.encode_points, hm.G1_GEN, 4096),
            ("g2_mul", st.g2_mul_rows, cv2.encode_points, hm.G2_GEN, 7936)):
        mul = hm.g1_mul if name == "g1_mul" else hm.g2_mul
        pool = torch.from_numpy(enc([mul(gen, rng.randrange(1, hm.R)) for _ in range(8)]))
        pts = pool[torch.arange(n_rows) % 8].contiguous().to(dev)
        ks = torch.from_numpy(cv.encode_scalars([rng.randrange(hm.R) for _ in range(n_rows)])).to(dev)
        print(f"{name} {n_rows} rows: {event_ms(lambda: fn(pts, ks), 5):.4f} ms; ptxas "
              f"{ptxas_line(_build.BUILD_LOG.get(name + '.cu', ''))}", flush=True)
    code_summary(write_sass("g1_msm.cu"), r"Function : \S+", SASS_PATS)
    code_summary(write_sass("final_exp.cu"), r"Function : \S+", SASS_PATS)
    print("failed:", bad)
    sys.exit(1 if bad else 0)

# ---------------------------------------------------------------- ladder
# g1_mul and g2_mul against their plain versions on the edges
print("ptxas g1_mul.cu:", ptxas_line(_build.BUILD_LOG.get("g1_mul.cu", "")), flush=True)
print("ptxas g2_mul.cu:", ptxas_line(_build.BUILD_LOG.get("g2_mul.cu", "")), flush=True)
edge_k = [0, 1, hm.R - 1, 16 ** 63 - 1, 5, rng.randrange(hm.R), rng.randrange(hm.R),
          rng.randrange(hm.R), rng.randrange(hm.R)]
g1e = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(8)] + [None]
g2e = [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(8)] + [None]
ke = torch.from_numpy(cv.encode_scalars(edge_k))
p1 = lifted(torch.from_numpy(cv.encode_points(g1e)), [5, 6, 8])
p2 = lifted(torch.from_numpy(cv2.encode_points(g2e)), [5, 6, 8])
chk("g1_mul edges", st.g1_mul_rows(p1.to(dev), ke.to(dev)), st.g1_mul_plain(p1, ke))
chk("g2_mul edges", st.g2_mul_rows(p2.to(dev), ke.to(dev)), st.g2_mul_plain(p2, ke))

# the sweep: each kernel built at every TPI, held against the built
# kernel and timed at the verify's rows
SWEEP = {"g1_mul": ("FTS_G1_MUL_TPI", (256, 4096, 7936), 3),
         "g2_mul": ("FTS_G2_MUL_TPI", (496, 7936), 6)}
procs = []
for name, (macro, _, _) in SWEEP.items():
    for tpi in (1, 2, 4, 8):
        lib = os.path.join(_build.BUILD_DIR, f"sweep-{name}-tpi{tpi}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", f"-D{macro}={tpi}",
               "-o", lib, os.path.join(_build.CSRC, f"{name}.cu")]
        procs.append((name, tpi, lib, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
variants = {}
for name, tpi, lib, t_start, proc in procs:
    log, _ = proc.communicate()
    print(f"sweep build {name} TPI={tpi}: rc {proc.returncode}, {time.perf_counter() - t_start:.1f} s;"
          f" ptxas {ptxas_line(log)}", flush=True)
    if proc.returncode != 0:
        print(log[-4000:])
        bad.append(f"build {name} TPI={tpi}")
        continue
    fn = ctypes.CDLL(lib)["fts_" + name]
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    variants[(name, tpi)] = fn
pool1 = torch.from_numpy(cv.encode_points(g1e[:8]))
pool2 = torch.from_numpy(cv2.encode_points(g2e[:8]))
sweep = {}
for name, (_, rows_list, reps) in SWEEP.items():
    pool, wrapper = (pool1, st.g1_mul_rows) if name == "g1_mul" else (pool2, st.g2_mul_rows)
    for rows in rows_list:
        pts = pool[torch.randint(0, 8, (rows,), generator=torch.Generator().manual_seed(rows))]
        pts = lifted(pts, range(0, rows, 7)).to(dev)
        ks = torch.from_numpy(cv.encode_scalars([rng.randrange(hm.R) for _ in range(rows)])).to(dev)
        want = wrapper(pts, ks)
        for tpi in (1, 2, 4, 8):
            fn = variants.get((name, tpi))
            if fn is None:
                continue
            out = torch.empty_like(want)
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                rc = fn(pts.data_ptr(), ks.data_ptr(), out.data_ptr(), rows, stream)
                if rc:
                    raise RuntimeError(f"{name} TPI={tpi}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            chk(f"sweep {name} TPI={tpi} {rows} rows vs the built kernel", out, want)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call()
            end.record()
            torch.cuda.synchronize()
            sweep[(name, tpi, rows)] = start.elapsed_time(end) / reps
            print(f"sweep {name} TPI={tpi} {rows} rows: {sweep[(name, tpi, rows)]:.4f} ms", flush=True)
print("sweep ms", {f"{n} TPI={t} rows={r}": round(v, 4) for (n, t, r), v in sweep.items()},
      flush=True)

for source in ("g1_mul.cu", "g2_mul.cu"):
    code_summary(write_sass(source), r"Function : \S+", SASS_PATS)
if args.ladder:
    print("failed:", bad)
    sys.exit(1 if bad else 0)
g1 = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(3)] + [None]
g2 = [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(3)]
p = torch.from_numpy(cv.encode_points(g1))
chk("g1_to_affine", st.g1_to_affine_rows(p.to(dev)), st.g1_to_affine_plain(p))
A = [g2[0], g2[0], g2[0], None, None, g2[1]]
B = [g2[0], hm.g2_neg(g2[0]), g2[1], g2[2], None, None]
a = torch.from_numpy(cv2.encode_points(A))
b = torch.from_numpy(cv2.encode_points(B))
chk("g2_add", st.g2_add_rows(a.to(dev), b.to(dev)), st.g2_add_plain(a, b))
chk("g2_to_affine", st.g2_to_affine_rows(a.to(dev)), st.g2_to_affine_plain(a))
pts = g2 + [None]
ks = [0, 1, hm.R - 1, rng.randrange(hm.R)]
pw = torch.from_numpy(cv2.encode_points(pts))
kw = torch.from_numpy(cv.encode_scalars(ks))
chk("g2_mul", st.g2_mul_rows(pw.to(dev), kw.to(dev)), st.g2_mul_plain(pw, kw))
Ps = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(2)] + [None]
Qs = [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(3)]
Pw = torch.from_numpy(pr.encode_g1(Ps))
Qw = torch.from_numpy(pr.encode_g2(Qs))
f = st.miller_rows(Pw.to(dev), Qw.to(dev))
chk("miller", f, st.miller_plain(Pw, Qw))
g = st.final_exp_rows(f)
chk("final_exp", g, st.final_exp_plain(f.cpu()))
print("pairing host", tw.decode_fp12(g.cpu())[:2] == [hm.pairing(x, y) for x, y in zip(Ps[:2], Qs[:2])])
ff = f.reshape(1, 3, 6, 2, 8).contiguous()
chk("gt_product", st.gt_product_rows(ff), st.gt_product_plain(ff.cpu()))


def once(name, fn):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    print(name, (time.perf_counter() - t) * 1e3, "ms", flush=True)


n = 1024
Pn, Qn = Pw[:1].repeat(n, 1, 1).to(dev), Qw[:1].repeat(n, 1, 1, 1).to(dev)
once("miller1024", lambda: st.miller_rows(Pn, Qn))
fn = f[:1].repeat(256, 1, 1, 1).contiguous()
once("final_exp256", lambda: st.final_exp_rows(fn))
pm, km = pw[:1].repeat(512, 1, 1, 1).to(dev), kw[3:4].repeat(512, 1).to(dev)
once("g2_mul512", lambda: st.g2_mul_rows(pm, km))

# ---------------------------------------------------------------- mesh plane
# the fused pairing product (both modes) against the staged kernels and
# the plain version on edge rows, one timing a mode at the membership
# check's block rows, and the sharded product on logical meshes
from fabric_token_sdk_tpu_torch.parallel import make_mesh, sharded_pairing_product  # noqa: E402

legs = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(7)] + [None]
qlegs = [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(8)]
Pe = torch.from_numpy(pr.encode_g1(legs)).to(dev)
Qe = torch.from_numpy(pr.encode_g2(qlegs)).to(dev)
fe = st.miller_rows(Pe, Qe)  # held against its plain version above
for k in (1, 2, 4):
    n_rows = 8 // k
    P4, Q4 = Pe.reshape(n_rows, k, 2, 8), Qe.reshape(n_rows, k, 2, 2, 8)
    staged = st.final_exp_rows(st.gt_product_rows(fe.reshape(n_rows, k, 6, 2, 8).contiguous()))
    chk(f"pairing_product K={k} vs staged", st.pairing_product_rows(P4, Q4), staged)
    chk(f"gt_product_final_exp K={k} vs staged",
        st.gt_product_final_exp_rows(fe.reshape(n_rows, k, 6, 2, 8).contiguous()), staged)
mask = torch.zeros((2, 4), dtype=torch.bool)
mask[0, 1] = mask[1, 3] = True  # row 1's (0, 0) leg masked: the same GT value
P4, Q4 = Pe.reshape(2, 4, 2, 8), Qe.reshape(2, 4, 2, 2, 8)
plain = st.pairing_product_plain(P4.cpu(), Q4.cpu(), mask.numpy())
chk("pairing_product masked vs plain", st.pairing_product_rows(P4, Q4, mask.numpy()), plain)
chk("pairing_staged masked vs plain", pr.pairing_product_staged(P4, Q4, mask.numpy()), plain)
for n_rows, k in ((248, 4), (64, 2)):
    Pn = P4[:1, :k].repeat(n_rows, 1, 1, 1).contiguous()
    Qn = Q4[:1, :k].repeat(n_rows, 1, 1, 1, 1).contiguous()
    fn_ = st.miller_rows(Pn.reshape(-1, 2, 8), Qn.reshape(-1, 2, 2, 8)).reshape(n_rows, k, 6, 2, 8)
    once(f"pairing_product {n_rows}x{k}", lambda: st.pairing_product_rows(Pn, Qn))
    once(f"gt_product_final_exp {n_rows}x{k}", lambda: st.gt_product_final_exp_rows(fn_))
    once(f"staged {n_rows}x{k}", lambda: pr.pairing_product_staged(Pn, Qn))
    chk(f"pairing_staged {n_rows}x{k}", pr.pairing_product_staged(Pn, Qn),
        st.pairing_product_rows(Pn, Qn))
for shape in ((2, 2), (1, 1)):
    mesh = make_mesh(shape[0] * shape[1], mp=shape[1], devices=[dev] * (shape[0] * shape[1]))
    for k_ in _build.ALL_KERNELS:
        k_.launches = 0
    got = sharded_pairing_product(P4, Q4, mesh, fused=True)
    print("fused mesh", shape, {k_.name: k_.launches for k_ in _build.ALL_KERNELS if k_.launches},
          flush=True)
    chk(f"sharded fused {shape} vs staged", got, pr.pairing_product_staged(P4, Q4))
print("build log pairing_fused.cu:", _build.BUILD_LOG.get("pairing_fused.cu", "")[-3000:], flush=True)

# ---------------------------------------------------------------- prove plane
from fabric_token_sdk_tpu_torch.crypto import batch as bt, setup as su, token as tok  # noqa: E402
from fabric_token_sdk_tpu_torch.crypto import transfer as tr  # noqa: E402

bases = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(3)]
table = cv.FixedBaseTable(bases).to(dev)
edges = [0, 1, hm.R - 1, (1 << 256) - 1, 9 << 84, int("fedcba9876543210" * 4, 16)]
rows = [[k] * 3 for k in edges] + [[rng.randrange(hm.R) for _ in range(3)] for _ in range(10)]
sc = torch.from_numpy(lb.ints_to_words([x for r in rows for x in r]).reshape(len(rows), 3, 8))
sel = st.g1_msm_select_rows(table.table, sc.to(dev))
chk("g1_msm_select", sel, st.g1_msm_select_plain(table.table.cpu(), sc))
chk("g1_msm_select vs gather", sel, st.g1_msm_rows(table.table, sc.to(dev)))
for n in (384, 640, 6144):
    zero = torch.zeros((n, 3, 8), dtype=torch.int32, device=dev)
    rnd = torch.from_numpy(cv.encode_scalars([rng.randrange(hm.R) for _ in range(3 * n)])
                           .reshape(n, 3, 8)).to(dev)
    for name, fn in (("select", st.g1_msm_select_rows), ("gather", st.g1_msm_rows)):
        for tag, s_ in (("zero", zero), ("random", rnd)):
            once(f"g1_msm {name} {n} rows {tag} scalars", lambda: fn(table.table, s_))

pp = su.setup(base=16, exponent=2, rng=rng)
reqs = []
for _ in range(4):
    ins, inw = tok.tokens_with_witness([100, 55], "USD", pp.ped_params, rng)
    outs, outw = tok.tokens_with_witness([120, 35], "USD", pp.ped_params, rng)
    reqs.append((inw, outw, ins, outs))
for k in _build.ALL_KERNELS:
    k.launches = 0
t = time.perf_counter()
proofs = tr.TransferProver.batch(reqs, pp, rng=rng, min_batch=1, device="cuda")
print("prove 4 2-in/2-out on cuda", (time.perf_counter() - t) * 1e3, "ms",
      {k.name: k.launches for k in _build.ALL_KERNELS}, flush=True)
ok = True
for r, raw in zip(reqs, proofs):
    try:
        tr.TransferVerifier(r[2], r[3], pp).verify(raw)
    except Exception as exc:  # noqa: BLE001
        ok = False
        print("host verifier rejects a proof from the card:", exc)
print("prove accepted by the host verifier", ok, flush=True)
if not ok:
    bad.append("prove")
rp = pp.range_params
sigs = list(rp.signed_values[:6]) + [rp.signed_values[1]]
msgs = [[v] for v in range(6)] + [[2]]
got = bt.BatchedPSVerifier(rp.sign_pk, rp.Q, device="cuda").verify(msgs, sigs).tolist()
print("ps verdicts", got, flush=True)
if got != [True] * 6 + [False]:
    bad.append("ps")

# the select kernel's code: PTX from nvcc, SASS from the built library
ptx = os.path.join(out_dir, "g1_msm.ptx")
src = os.path.join(_build.CSRC, "g1_msm.cu")
subprocess.run([_build.find_nvcc(), "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                f"-I{_build.CSRC}", "-ptx", "-o", ptx, src], check=False)
code_summary(ptx, r"\.entry \S+", {"loads": r"ld\.global", "predicated loads": r"@%p\d+\s+ld\.global",
                                    "branches": r"\bbra"})
code_summary(write_sass("g1_msm.cu"), r"Function : \S+", SASS_PATS)
print("launches", {k.name: k.launches for k in _build.ALL_KERNELS})
print("failed:", bad)
sys.exit(1 if bad else 0)
