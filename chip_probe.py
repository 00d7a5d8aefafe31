#!/usr/bin/env python3
"""Quick first call on the GPU after a kernel change: build, check, stop.

    python3 chip_probe.py [OUT_DIR]

Builds every CUDA source of the PyTorch port with `nvcc` and prints each
source's `ptxas -v` report, then holds the range-path kernels (G1 and G2
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
its loads, predicated loads and branches. It takes about two minutes
of command time where `chip_smoke.py` takes six or more: the place to
find a kernel that does not build or disagrees before the full smoke
run. Needs one NVIDIA GPU; imports nothing of JAX.
"""
import glob
import os
import random
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
t0 = time.perf_counter()
try:
    _build.build_all()
finally:
    for src, log in sorted(_build.BUILD_LOG.items()):
        print("=====", src)
        print(log[-6000:])
print("build s", time.perf_counter() - t0, flush=True)
dev = torch.device("cuda")
rng = random.Random(3)
g1 = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(3)] + [None]
g2 = [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(3)]
bad = []


def chk(name, got, want):
    ok = torch.equal(got.cpu(), want.cpu())
    print(name, "OK" if ok else "MISMATCH", flush=True)
    if not ok:
        bad.append(name)


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
out_dir = sys.argv[1] if len(sys.argv) > 1 else "probe_out"
os.makedirs(out_dir, exist_ok=True)
ptx, sass = os.path.join(out_dir, "g1_msm.ptx"), os.path.join(out_dir, "g1_msm.sass")
src = os.path.join(_build.CSRC, "g1_msm.cu")
subprocess.run([_build.find_nvcc(), "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                f"-I{_build.CSRC}", "-ptx", "-o", ptx, src], check=False)
lib = glob.glob(os.path.join(_build.BUILD_DIR, "g1_msm-*.so"))
cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
if lib and os.path.exists(cuobjdump):
    with open(sass, "w") as fh:
        subprocess.run([cuobjdump, "-sass", lib[0]], stdout=fh, stderr=subprocess.STDOUT,
                       check=False)


def code_summary(path, start_pat, load_pat, pred_load_pat, branch_pat):
    if not os.path.exists(path):
        print("no", path)
        return
    text = open(path).read()
    for m in re.finditer(start_pat, text):
        body = text[m.start():]
        nxt = re.search(start_pat, body[1:])
        body = body[: nxt.start() + 1] if nxt else body
        print(path, m.group(0)[:80], "loads", len(re.findall(load_pat, body)),
              "predicated loads", len(re.findall(pred_load_pat, body)),
              "branches", len(re.findall(branch_pat, body)), flush=True)


code_summary(ptx, r"\.entry \S+", r"ld\.global", r"@%p\d+\s+ld\.global",
             r"\bbra")
code_summary(sass, r"Function : \S+", r"LDG", r"@!?P\d\s+LDG", r"\bBRA\b")
print("launches", {k.name: k.launches for k in _build.ALL_KERNELS})
print("failed:", bad)
sys.exit(1 if bad else 0)
