"""The mesh plane: batched work spread over a (dp, mp) grid of devices.

Counterpart of `fabric_token_sdk_tpu/parallel/sharding.py`. A mesh is a
`DeviceMesh` from `make_mesh`. A batch is padded to a dp multiple by
repeating row 0 (`shard_rows`), and its row group i (the i-th of dp
equal row spans) runs on the devices of mesh row i; the results come
back to the caller's device in row order, the padding sliced off.

* `run_rows_dp` runs a `*_rows` stage function, or a composition of
  them such as `sharded_schnorr_rows`, once a row group on the group's
  first device: bit-identical to one call over all rows. A call over
  dp > 1 groups counts `stages.sharded_calls` and its groups
  `stages.shards`, the reference's names.
* `sharded_pairing_product` without `fused` runs the staged sequence
  once a row group on the group's first device
  (`pairing.staged.sharded_calls`, `pairing.staged.shards`). The legs
  split over mp only in the fused product: the staged kernels take all
  K legs of a row in one launch.
* `sharded_pairing_product(fused=True)` is the port of the reference's
  `shard_map` program, single-controller as it is. For each cell (i, j)
  the Miller loops of row span i and leg span j run on device (i, j);
  their values are gathered over mp onto device (i, 0) (peer copies),
  which runs the product and one final exponentiation
  (`csrc/pairing_fused.cu`, `fts_gt_product_final_exp`). The reference
  runs that tail on every device of the row and keeps one copy; here it
  runs once. When mp = 1 a row group is one launch of
  `fts_pairing_product`, the whole product a row.
* `MeshBound` is the batched planes' binding to a mesh (the reference's
  `crypto/batch.py:_MeshBound`): `set_mesh(mesh)` binds a plane and
  copies its fixed tensors (the window tables) once to each distinct
  device of the mesh, and `_run(rows_fn, *arrays, consts=())` dispatches
  a stage over the mesh's row groups, or calls it directly when the
  plane is unbound. Results never depend on the mesh.

Launches to different devices are queued from the caller's thread and
run concurrently on the cards; a logical mesh (a device list that
repeats one device, `make_mesh(devices=...)`) runs its row groups one
after another on that device. No mesh (None) is one launch a stage over
all rows on the tensors' device. A `MeshConfig` is a mesh's shape only:
it names no device, and the entry points and `set_mesh` refuse it
(`TypeError`).

Each mesh call is one dispatch of the ledger (`utils/devobs.py`), timed
on the card by its devices' events, beside the dispatches of the kernels
it launches. A non-dividing `mp` is clamped (`sharding.clamped`) and padding counted
(`sharding.padded_rows`), as in the reference; a K that mp does not
divide takes the staged path (`sharding.fallbacks`), a planning
decision. A device error propagates: there is no unsharded re-run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops import curve as cv, pairing as pr, stages as st
from ..utils import devobs
from ..utils import metrics as mx


def _clamp_mp(n: int, mp: int, where: str) -> int:
    """Largest divisor of n that is <= mp (>= 1). A non-dividing mp is
    clamped, not rejected, and counted: `sharding.clamped`,
    `sharding.clamped.<where>` and a `sharding.clamped` flight event."""
    mp = max(1, mp)
    want = mp
    while n % mp:
        mp -= 1
    if mp != want:
        mx.counter("sharding.clamped").inc()
        mx.counter(f"sharding.clamped.{where.lower()}").inc()
        mx.flight("sharding.clamped", where=where, want=want, got=mp, n_devices=n)
        mx.logger.warning("sharding: %s clamped mp %d -> %d (n_devices=%d)", where, want, mp, n)
    return mp


@dataclass(frozen=True)
class MeshConfig:
    """A mesh's shape: `n_devices` = dp * mp, dp over rows, mp over
    pairing legs. It names no device; `make_mesh` lays one over
    devices."""

    n_devices: int
    dp: int
    mp: int = 1

    @classmethod
    def build(cls, n_devices: int, mp: int = 1) -> "MeshConfig":
        """The shape over n_devices with mp clamped to a divisor."""
        n = max(1, int(n_devices))
        mp = _clamp_mp(n, int(mp), "MeshConfig")
        return cls(n_devices=n, dp=n // mp, mp=mp)

    @classmethod
    def of(cls, mesh) -> Optional["MeshConfig"]:
        """The shape of a DeviceMesh (or of the reference's mesh); a
        MeshConfig or None passes through."""
        if mesh is None or isinstance(mesh, cls):
            return mesh
        dp = int(mesh.shape["dp"])
        mp = int(mesh.shape.get("mp", 1))
        return cls(n_devices=dp * mp, dp=dp, mp=mp)


@dataclass(frozen=True)
class DeviceMesh:
    """A (dp, mp) grid of torch devices, row i the devices of row group i
    (the counterpart of a `jax.sharding.Mesh` with axes ("dp", "mp"))."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "mp": len(self.devices[0])}


def make_mesh(n_devices: Optional[int] = None, mp: int = 1,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A (dp, mp) mesh over the first `n_devices` CUDA devices (all of
    them by default), mp clamped to a divisor. Raises when fewer CUDA
    devices exist. `devices=` lays the mesh over the given list instead;
    a list that repeats one device is a logical mesh on it (the
    counterpart of the reference's virtual CPU devices)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_devices or count
        if n <= 0 or count < n:
            raise RuntimeError(f"make_mesh: {n} devices asked for and {count} CUDA devices "
                               "present; pass devices= for a logical mesh")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(d) for d in devices]
        n = n_devices or len(devs)
        if n <= 0 or n > len(devs):
            raise ValueError(f"make_mesh: {n} devices asked for from a list of {len(devs)}")
        devs = devs[:n]
    mp = _clamp_mp(n, mp, "make_mesh")
    return DeviceMesh(tuple(tuple(devs[i * mp:(i + 1) * mp]) for i in range(n // mp)))


def _device_mesh(mesh) -> DeviceMesh:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a DeviceMesh from make_mesh is needed, not {type(mesh).__name__} "
                        "(a MeshConfig names no devices)")
    return mesh


def _mesh_devices(mesh: DeviceMesh) -> list:
    """Every device of the mesh: a mesh dispatch's time is the longest of
    their timing-event pairs (`utils/devobs.py`)."""
    return [d for row in mesh.devices for d in row]


def _pad(a: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))]) if pad else a


def shard_rows(arr, mesh: DeviceMesh) -> torch.Tensor:
    """The rows of `arr` padded to a dp multiple by repeating row 0
    (`sharding.padded_rows`); row span i of the result belongs to row
    group i. Callers slice their result back to the original count."""
    a = torch.as_tensor(arr)
    pad = (-a.shape[0]) % int(mesh.shape["dp"])
    if pad:
        mx.counter("sharding.padded_rows").inc(pad)
    return _pad(a, pad)


def _on_row_groups(body, arrays, mesh: DeviceMesh) -> torch.Tensor:
    """`body(group, *spans)` for each row group and its row spans of
    `arrays` (padded by `shard_rows`); the results concatenated on the
    caller's device in row order, padding sliced off."""
    B, dp = arrays[0].shape[0], len(mesh.devices)
    padded = [shard_rows(arrays[0], mesh)]
    padded += [_pad(a, (-B) % dp) for a in arrays[1:]]
    b = padded[0].shape[0] // dp
    outs = [body(group, *(a[i * b:(i + 1) * b] for a in padded))
            for i, group in enumerate(mesh.devices)]
    return torch.cat([o.to(arrays[0].device) for o in outs])[:B]


def _count_sharded(calls, shards, n: int) -> None:
    """A dispatch over n > 1 row groups of the mesh: one call and n shards
    on the two counters."""
    if n > 1:
        calls.inc()
        shards.inc(n)


def run_rows_dp(rows_fn, *arrays, mesh: Optional[DeviceMesh] = None, consts=(),
                placed: Optional[Dict[tuple, torch.Tensor]] = None) -> torch.Tensor:
    """`rows_fn(*consts, *arrays)` over the mesh's row groups, each on its
    first device with `consts` (tables) there: the copy `placed` holds
    under `(id(const), str(device))` (a bound plane's, made when it was
    bound), else one made for the call. One call on the tensors' device
    without a mesh. Bit-identical either way."""
    if mesh is None:
        return rows_fn(*consts, *arrays)
    mesh = _device_mesh(mesh)
    B, dp = arrays[0].shape[0], mesh.shape["dp"]
    placed = placed or {}

    def on(x, dev):
        copy = placed.get((id(x), str(dev)))
        return x.to(dev) if copy is None else copy

    with devobs.dispatch(rows_fn.__name__, rows=B, padded_rows=(-B) % dp, dp=dp,
                         mp=mesh.shape["mp"], device=_mesh_devices(mesh)):
        out = _on_row_groups(
            lambda group, *spans: rows_fn(*(on(c, group[0]) for c in consts),
                                          *(x.to(group[0]) for x in spans)),
            arrays, mesh)
    _count_sharded(mx.counter("stages.sharded_calls"), mx.counter("stages.shards"), dp)
    return out


def schnorr_rows(table: torch.Tensor, resp: torch.Tensor, stmts: torch.Tensor,
                 chals: torch.Tensor) -> torch.Tensor:
    """com = table^resp - stmt^chal: the gather msm, `g1_mul`, `g1_sub`."""
    return st.g1_sub_rows(st.g1_msm_rows(table, resp), st.g1_mul_rows(stmts, chals))


def sharded_schnorr_rows(table, resp: torch.Tensor, stmts: torch.Tensor, chals: torch.Tensor,
                         mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Schnorr commitment reconstruction com = table^resp - stmt^chal over
    the mesh's row groups: the composition `BatchedWFVerifier` runs
    (responses and challenges are public). `table` a `FixedBaseTable`
    (or its table tensor), resp (N, nbases, 8), stmts (N, 3, 8) Jacobian,
    chals (N, 8) canonical, on one device; returns (N, 3, 8) Jacobian
    there."""
    tab = table.table if isinstance(table, cv.FixedBaseTable) else table
    return run_rows_dp(schnorr_rows, resp, stmts, chals, mesh=mesh, consts=(tab,))


def _staged_row_group(group, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """One row group of the staged product: the staged sequence on group[0]."""
    return pr.pairing_product_staged(P.to(group[0]), Q.to(group[0]))


def _fused_row_group(group, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """One row group of the fused product, P (b, K, 2, 8) and Q
    (b, K, 2, 2, 8): one fused launch on group[0] when mp = 1; else the
    Miller loops of leg span j on device j of the group, their values
    gathered onto group[0] in leg order, and the tail there."""
    if len(group) == 1:
        return st.pairing_product_rows(P.to(group[0]), Q.to(group[0]))
    b, K = P.shape[0], P.shape[1]
    kl = K // len(group)
    f = []
    for j, dev in enumerate(group):
        legs = slice(j * kl, (j + 1) * kl)
        Pj = P[:, legs].reshape(b * kl, 2, -1).contiguous().to(dev)
        Qj = Q[:, legs].reshape(b * kl, 2, 2, -1).contiguous().to(dev)
        f.append(st.miller_rows(Pj, Qj).reshape(b, kl, 6, 2, -1))
    # all_gather over mp, onto the one device that runs the tail
    return st.gt_product_final_exp_rows(torch.cat([x.to(group[0]) for x in f], dim=1).contiguous())


def sharded_pairing_product(Ps: torch.Tensor, Qs: torch.Tensor, mesh: Optional[DeviceMesh] = None,
                            fused: bool = False) -> torch.Tensor:
    """prod_k e(P_k, Q_k) per row over the mesh: Ps (B, K, 2, 8), Qs
    (B, K, 2, 2, 8) tensors; returns (B, 6, 2, 8) canonical GT on Ps'
    device.

    No mesh: the staged sequence on Ps' device. With a mesh: each row
    group on its devices, by the fused product when `fused` (the legs
    split over mp; a K that mp does not divide degrades to the staged
    sequence, `sharding.fallbacks`), else by the staged sequence on the
    group's first device (`pairing.staged.sharded_calls`)."""
    if mesh is None:
        return pr.pairing_product_staged(Ps, Qs)
    mesh = _device_mesh(mesh)
    dp, mp = mesh.shape["dp"], mesh.shape["mp"]
    B, K = Ps.shape[0], Ps.shape[1]
    if fused and K % mp:
        mx.counter("sharding.fallbacks").inc()
        mx.flight("sharding.fallback", what="fused_pairing", workers=dp * mp,
                  reason="k_not_divisible", k=K, mp=mp)
        devobs.note_degrade("k_not_divisible", "fused_pairing")
        mx.logger.warning("sharding: fused pairing product needs K %% mp == 0 (K=%d, mp=%d); "
                          "degrading to the staged sequence", K, mp)
        fused = False
    program, body = ("fused_pairing", _fused_row_group) if fused else \
        ("pairing_product_staged", _staged_row_group)
    with devobs.dispatch(program, rows=B * K, padded_rows=((-B) % dp) * K, dp=dp, mp=mp,
                         device=_mesh_devices(mesh)):
        out = _on_row_groups(body, (Ps, Qs), mesh)
    if not fused:
        _count_sharded(mx.counter("pairing.staged.sharded_calls"),
                       mx.counter("pairing.staged.shards"), dp)
    return out


# ------------------------------------------------------------ mesh binding

def same_device(a, b) -> bool:
    """Whether two device specs name one device: None is the card, and a
    CUDA device without an index is the current one."""
    def norm(d):
        d = torch.device("cuda" if d is None else d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device()
                                if torch.cuda.is_available() else 0)
        return d
    return norm(a) == norm(b)


def mesh_on_device(mesh, device) -> DeviceMesh:
    """`mesh` checked for binding a plane on `device`: a `MeshConfig`
    names no device (TypeError), and a mesh whose first device is not
    `device` raises ValueError."""
    mesh = _device_mesh(mesh)
    if not same_device(mesh.devices[0][0], device):
        raise ValueError(f"the mesh's first device {mesh.devices[0][0]} is not the plane's "
                         f"device {device}: lay the mesh over it")
    return mesh


class MeshBound:
    """Mixin of the batched planes: a plane bound to an optional
    `DeviceMesh` (the counterpart of the reference's
    `crypto/batch.py:_MeshBound`). Its stage calls and pairing products
    run over the mesh's row groups (a fused product's legs also over mp,
    `sharded_pairing_product`); unbound (None) each is one launch over
    all rows. The plane defines `device` and lists its fixed tensors in
    `_mesh_tables()`; binding copies each once to every distinct device
    that runs a row group. Results never depend on the mesh, only the
    dispatch does."""

    mesh: Optional[DeviceMesh] = None
    _replicas: Dict[tuple, torch.Tensor] = {}

    def _mesh_tables(self) -> tuple:
        """The tensors every row group reads (window tables)."""
        return ()

    def set_mesh(self, mesh: Optional[DeviceMesh]) -> None:
        """Bind the plane to `mesh` (None unbinds). A `MeshConfig` names no
        device (TypeError); a mesh whose first device is not the plane's
        raises ValueError."""
        replicas = {}
        if mesh is not None:
            mesh = mesh_on_device(mesh, self.device)
            for dev in {str(row[0]): row[0] for row in mesh.devices}.values():
                for t in self._mesh_tables():
                    replicas[(id(t), str(dev))] = t if same_device(t.device, dev) else t.to(dev)
        self.mesh = mesh
        self._replicas = replicas

    def _run(self, rows_fn, *arrays, consts=()) -> torch.Tensor:
        """`rows_fn(*consts, *arrays)` over the bound mesh's row groups
        (`run_rows_dp`, the tables from the binding's copies), or one call
        when the plane is unbound."""
        if self.mesh is None:
            return rows_fn(*consts, *arrays)
        return run_rows_dp(rows_fn, *arrays, mesh=self.mesh, consts=consts,
                           placed=self._replicas)
