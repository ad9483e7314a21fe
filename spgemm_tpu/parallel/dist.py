"""Multi-chip SpGEMM over a jax.sharding.Mesh.

The reference is single-GPU (SURVEY.md 2.7); this module is the
framework's distributed extension per the north-star spec
(BASELINE.json): **A tile-rows partitioned across devices, B tiles
all-gathered, C tiles owner-computed** — SPMD via jax.shard_map, with
XLA inserting the collectives.

Partitioning: C tile-row i is owned by the device owning A tile-row i,
so every pair (A(i,k), B(k,j)) lands on the owner of its output tile —
no cross-device reduction is needed (contrast with an A-column split
which would psum). Devices exchange only B tiles (one all-gather), which
overlaps with the first pair chunks under XLA's scheduler.

Host-side planning (plan_row_partition) balances devices by *pair count*
(compute load), not tile count, then pads every per-device array to the
max so shapes are identical across shards — the SPMD analogue of the
reference's size-binned kernel dispatch.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from spgemm_tpu.models.csr import INDEX_DTYPE
from spgemm_tpu.models.tile import TileMat, cdiv
from spgemm_tpu.ops.symbolic import PairSchedule, build_pair_schedule


@dataclasses.dataclass
class DistPlan:
    """Host-side SPMD execution plan for one (A, B, mesh-size) triple.

    The partition (which rows, tiles and pairs each device owns) is
    always set; the per-device padded arrays, stacked on axis 0 (the mesh
    axis), are set by plan_row_partition and left None by
    place_strip_partition, which packs one shard at a time."""

    ndev: int
    s_max: int           # local segments per device (excl. dummy)
    # bookkeeping to reassemble C on host
    seg_counts: np.ndarray   # (D,) real segments per device
    ctrow: np.ndarray        # (ntC,) global candidate C tile coords
    ctcol: np.ndarray
    schedule: PairSchedule
    # partition: device d owns A tiles [a_lo[d], a_hi[d]), B tiles
    # [d*ntb_shard, (d+1)*ntb_shard) and the pairs with pair_dev == d
    a_lo: np.ndarray
    a_hi: np.ndarray
    nta_max: int
    ntb_shard: int
    seg_off: np.ndarray
    pair_dev: np.ndarray
    p_max: int
    a_val: np.ndarray | None = None    # (D, ntA_max, tm, tk)
    a_occ: np.ndarray | None = None
    b_val: np.ndarray | None = None    # (D, ntB_shard, tk, tn) (all-gathered on device)
    b_occ: np.ndarray | None = None
    pa: np.ndarray | None = None       # (D, P_max) local A tile index
    pb: np.ndarray | None = None       # (D, P_max) index into the all-gathered padded B
    seg: np.ndarray | None = None      # (D, P_max) local C segment, sorted; padding -> S_max


_DIST_ARRAYS = ("a_val", "a_occ", "b_val", "b_occ", "pa", "pb", "seg")


def _partition(a: TileMat, b: TileMat, ndev: int) -> DistPlan:
    """Partition A tile-rows (and C tile-rows with them) over `ndev`
    devices, balancing total pair count per device. Host arrays: the
    pair schedule and per-device bounds only."""
    sched = build_pair_schedule(a, b)

    # pairs per C tile-row -> contiguous row ranges with ~equal pairs
    pairs_per_seg = np.diff(sched.pair_ptr).astype(np.int64)
    seg_row = sched.ctrow  # sorted ascending
    pairs_per_row = np.zeros(a.gm, dtype=np.int64)
    np.add.at(pairs_per_row, seg_row, pairs_per_seg)
    cum = np.cumsum(pairs_per_row)
    total = int(cum[-1]) if cum.size else 0
    # row range for device d: rows with cum in (d*total/D, (d+1)*total/D]
    bounds = np.searchsorted(cum, np.arange(1, ndev) * (total / ndev))
    row_start = np.concatenate([[0], bounds + 1]) if ndev > 1 else np.array([0])
    row_end = np.concatenate([bounds + 1, [a.gm]]) if ndev > 1 else np.array([a.gm])

    # A tiles are sorted by tile-row: device ranges are contiguous slices
    a_lo = a.tptr[row_start].astype(np.int64)
    a_hi = a.tptr[row_end].astype(np.int64)

    # segments (C tiles) per device: contiguous because ctrow is sorted
    seg_dev = np.searchsorted(row_start[1:], seg_row, side="right") \
        if ndev > 1 else np.zeros(sched.nt_c, dtype=np.int64)
    seg_counts = np.bincount(seg_dev, minlength=ndev)
    pair_dev = seg_dev[sched.seg] if sched.num_pairs else np.zeros(0, np.int64)
    p_counts = np.bincount(pair_dev, minlength=ndev)
    return DistPlan(
        ndev=ndev,
        s_max=max(1, int(seg_counts.max()) if sched.nt_c else 1),
        seg_counts=seg_counts, ctrow=sched.ctrow, ctcol=sched.ctcol,
        schedule=sched, a_lo=a_lo, a_hi=a_hi,
        nta_max=max(1, int((a_hi - a_lo).max()) if a.nt else 1),
        # B tiles: even contiguous shard; devices all-gather at run time
        ntb_shard=max(1, cdiv(max(b.nt, 1), ndev)),
        seg_off=np.concatenate([[0], np.cumsum(seg_counts)[:-1]]),
        pair_dev=pair_dev,
        p_max=max(1, int(p_counts.max()) if sched.num_pairs else 1),
    )


def _pack_tile_range(t: TileMat, lo: int, hi: int, n_pad: int, dtype):
    """Dense values and bf16 0/1 occupancy of tiles [lo, hi) of `t`,
    zero-padded to n_pad tiles: two (1, n_pad, tm, tn) host arrays.
    bf16 occupancy is exact for 0/1 operands."""
    hi = min(hi, t.nt)
    lo = min(lo, hi)
    nlo, nhi = int(t.tnnz_ptr[lo]), int(t.tnnz_ptr[hi])
    tid = np.repeat(np.arange(hi - lo, dtype=np.int64),
                    np.diff(t.tnnz_ptr[lo : hi + 1]).astype(np.int64))
    flat = tid * (t.tm * t.tn) + t.rc[nlo:nhi]
    val = np.zeros(n_pad * t.tm * t.tn, dtype=dtype)
    occ = np.zeros(n_pad * t.tm * t.tn, dtype=jnp.bfloat16)
    val[flat] = t.val[nlo:nhi]
    occ[flat] = 1
    shape = (1, n_pad, t.tm, t.tn)
    return val.reshape(shape), occ.reshape(shape)


def _shard_arrays(plan: DistPlan, a: TileMat, b: TileMat, d: int,
                  dtype=np.float32) -> dict:
    """Device d's padded slice of every plan array, each (1, ...), packed
    from A's and B's own tiles: host memory for one shard only."""
    sched = plan.schedule
    a_val, a_occ = _pack_tile_range(a, int(plan.a_lo[d]), int(plan.a_hi[d]),
                                    plan.nta_max, dtype)
    k0 = d * plan.ntb_shard
    b_val, b_occ = _pack_tile_range(b, k0, k0 + plan.ntb_shard,
                                    plan.ntb_shard, dtype)
    sel = plan.pair_dev == d
    n = int(sel.sum())
    pa = np.zeros((1, plan.p_max), dtype=np.int32)
    pb = np.zeros((1, plan.p_max), dtype=np.int32)
    seg = np.full((1, plan.p_max), plan.s_max, dtype=np.int32)  # pad -> dummy
    pa[0, :n] = sched.pa[sel] - plan.a_lo[d]
    pb[0, :n] = sched.pb[sel]           # global == all-gathered index
    # pairs stay grouped by segment within a device (padding sorts last)
    seg[0, :n] = sched.seg[sel] - plan.seg_off[d]
    return dict(a_val=a_val, a_occ=a_occ, b_val=b_val, b_occ=b_occ,
                pa=pa, pb=pb, seg=seg)


def plan_row_partition(
    a: TileMat, b: TileMat, ndev: int, dtype=np.float32
) -> DistPlan:
    """Partition A tile-rows (and C tile-rows with them) over `ndev`
    devices, balancing total pair count per device, with every device's
    padded arrays stacked on the host (place_strip_partition stages the
    same arrays one shard at a time instead)."""
    plan = _partition(a, b, ndev)
    shards = [_shard_arrays(plan, a, b, d, dtype) for d in range(ndev)]
    for name in _DIST_ARRAYS:
        setattr(plan, name, np.concatenate([sh[name] for sh in shards]))
    return plan


def _device_fn(a_val, a_occ, b_val, b_occ, pa, pb, seg, *, s_max, acc_dtype):
    """Per-shard body: all-gather B, then local pair products."""
    b_val_g = jax.lax.all_gather(b_val[0], "x", axis=0, tiled=True)
    b_occ_g = jax.lax.all_gather(b_occ[0], "x", axis=0, tiled=True)

    prod = jax.lax.dot_general(
        a_val[0][pa[0]], b_val_g[pb[0]],
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=acc_dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    cnt = jax.lax.dot_general(
        a_occ[0][pa[0]], b_occ_g[pb[0]],
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    tm, tn = prod.shape[1], prod.shape[2]
    c_val = jnp.zeros((s_max + 1, tm, tn), acc_dtype)
    c_cnt = jnp.zeros((s_max + 1, tm, tn), jnp.float32)
    c_val = c_val.at[seg[0]].add(prod)
    c_cnt = c_cnt.at[seg[0]].add(cnt)
    return c_val[None, :-1], c_cnt[None, :-1]


def spgemm_sharded_pairs(
    a: TileMat,
    b: TileMat,
    mesh: Mesh,
    *,
    acc_dtype=jnp.float32,
) -> TileMat:
    """Pair-gather distributed SpGEMM (simple, used as a cross-check for
    the gustavson SPMD path)."""
    ndev = mesh.devices.size
    plan = plan_row_partition(a, b, ndev)

    fn = jax.jit(
        jax.shard_map(
            functools.partial(
                _device_fn, s_max=plan.s_max, acc_dtype=acc_dtype
            ),
            mesh=mesh,
            in_specs=(P("x"),) * 7,
            out_specs=(P("x"), P("x")),
            check_vma=False,
        )
    )
    c_val_d, c_cnt_d = fn(
        jnp.asarray(plan.a_val), jnp.asarray(plan.a_occ),
        jnp.asarray(plan.b_val), jnp.asarray(plan.b_occ),
        jnp.asarray(plan.pa), jnp.asarray(plan.pb), jnp.asarray(plan.seg),
    )
    # reassemble: device d's first seg_counts[d] segments are real
    c_val = np.asarray(c_val_d, dtype=np.float64).reshape(
        ndev, plan.s_max, a.tm, b.tn
    )
    c_cnt = np.asarray(c_cnt_d).reshape(ndev, plan.s_max, a.tm, b.tn)
    keep_val = np.concatenate(
        [c_val[d, : plan.seg_counts[d]] for d in range(ndev)]
    ) if plan.ctrow.size else np.zeros((0, a.tm, b.tn))
    keep_cnt = np.concatenate(
        [c_cnt[d, : plan.seg_counts[d]] for d in range(ndev)]
    ) if plan.ctrow.size else np.zeros((0, a.tm, b.tn))

    from spgemm_tpu.ops.spgemm import _compact_to_tilemat

    return _compact_to_tilemat(
        plan.ctrow, plan.ctcol, keep_val, keep_cnt,
        (a.m, b.n), a.tm, b.tn,
    )


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]).reshape(n), ("x",))


# --- Gustavson SPMD path (the production formulation) ---------------------


@dataclasses.dataclass
class GustavsonDistPlan:
    ndev: int
    gk: int
    max_a: int          # max A tiles per (device, k)
    max_b: int
    tm: int
    tn: int
    s_max: int
    a3_val: np.ndarray  # (D, gk, max_a*tm, tk)
    a3_occ: np.ndarray
    b3_val: np.ndarray  # (D, gk_shard, tk, max_b*tn) sharded over k
    b3_occ: np.ndarray
    seg: np.ndarray     # (D, gk*max_a*max_b) local segments, pad -> s_max
    seg_counts: np.ndarray
    ctrow: np.ndarray   # global C tile coords (concatenated device order)
    ctcol: np.ndarray


def plan_gustavson_partition(
    a: TileMat, b: TileMat, ndev: int, dtype=np.float32
) -> GustavsonDistPlan:
    """Row-partition A (balanced by pair count) and build one Gustavson
    plan per device; B slabs are built once and sharded over k."""
    from spgemm_tpu.models.tile import cdiv
    from spgemm_tpu.ops.gustavson import build_gustavson_plan

    # balance rows by pairs (reuse the expansion logic cheaply)
    k = a.tcol.astype(np.int64)
    bptr = b.tptr.astype(np.int64)
    pair_per_tile = bptr[k + 1] - bptr[k]
    pairs_per_row = np.zeros(a.gm, dtype=np.int64)
    np.add.at(pairs_per_row, a.trow, pair_per_tile)
    cum = np.cumsum(pairs_per_row)
    total = int(cum[-1]) if cum.size else 0
    bounds = np.searchsorted(cum, np.arange(1, ndev) * (total / ndev))
    row_start = np.concatenate([[0], bounds + 1]) if ndev > 1 else np.array([0])
    row_end = np.concatenate([bounds + 1, [a.gm]]) if ndev > 1 else np.array([a.gm])

    plans = []
    for d in range(ndev):
        a_d = a.slice_tile_rows(int(row_start[d]), int(row_end[d]))
        plans.append(build_gustavson_plan(a_d, b, dtype=dtype))

    gk = plans[0].gk
    tm, tk, tn = a.tm, a.tn, b.tn
    max_a = max(1, max(p.max_a for p in plans))
    max_b = max(1, max(p.max_b for p in plans))
    s_max = max(1, max(p.nt_c for p in plans))

    a3_val = np.zeros((ndev, gk, max_a * tm, tk), dtype=dtype)
    a3_occ = np.zeros_like(a3_val)
    seg = np.full((ndev, gk * max_a * max_b), s_max, dtype=np.int32)
    ctrow_parts, ctcol_parts = [], []
    for d, p in enumerate(plans):
        a3_val[d, :, : p.max_a * tm] = p.a3_val
        a3_occ[d, :, : p.max_a * tm] = p.a3_occ
        # remap seg slots (gk, p.max_a, p.max_b) -> (gk, max_a, max_b)
        src = p.seg.reshape(gk, p.max_a, p.max_b)
        dst = seg[d].reshape(gk, max_a, max_b)
        dst[:, : p.max_a, : p.max_b] = np.where(
            src == p.nt_c, s_max, src
        )
        ctrow_parts.append(p.ctrow + int(row_start[d]))
        ctcol_parts.append(p.ctcol)

    # B slabs: shared across devices; shard over k (pad gk to D multiple)
    bp = plans[0]
    gk_shard = cdiv(gk, ndev)
    b3_val = np.zeros((ndev, gk_shard, tk, max_b * tn), dtype=dtype)
    b3_occ = np.zeros_like(b3_val)
    bsrc_v = np.zeros((gk_shard * ndev, tk, max_b * tn), dtype=dtype)
    bsrc_o = np.zeros_like(bsrc_v)
    bsrc_v[:gk, :, : bp.max_b * tn] = bp.b3_val
    bsrc_o[:gk, :, : bp.max_b * tn] = bp.b3_occ
    for d in range(ndev):
        b3_val[d] = bsrc_v[d * gk_shard : (d + 1) * gk_shard]
        b3_occ[d] = bsrc_o[d * gk_shard : (d + 1) * gk_shard]

    return GustavsonDistPlan(
        ndev=ndev, gk=gk, max_a=max_a, max_b=max_b, tm=tm, tn=tn,
        s_max=s_max,
        a3_val=a3_val, a3_occ=a3_occ, b3_val=b3_val, b3_occ=b3_occ,
        seg=seg,
        seg_counts=np.array([p.nt_c for p in plans]),
        ctrow=np.concatenate(ctrow_parts) if plans else np.zeros(0, np.int32),
        ctcol=np.concatenate(ctcol_parts) if plans else np.zeros(0, np.int32),
    )


def spgemm_sharded(
    a: TileMat,
    b: TileMat,
    mesh: Mesh,
    *,
    acc_dtype=jnp.float32,
    inspect=None,
) -> TileMat:
    """Distributed C = A @ B over all devices of `mesh` (one axis "x"):
    A tile-rows partitioned per device (pair-count balanced), B slabs
    sharded over the inner dimension and all-gathered inside the
    shard_map body, C tiles owner-computed with the Gustavson slab
    formulation (no cross-device reduction).
    `inspect`, when given, is called with the sharded device outputs
    before the host assembles C (the card smoke run prints where each
    output shard lives)."""
    from spgemm_tpu.ops.gustavson import gustavson_core

    ndev = mesh.devices.size
    plan = plan_gustavson_partition(a, b, ndev)
    gk_pad = plan.b3_val.shape[1] * ndev

    def device_fn(a3v, a3o, b3v, b3o, seg):
        b3v_g = jax.lax.all_gather(b3v[0], "x", axis=0, tiled=True)[: plan.gk]
        b3o_g = jax.lax.all_gather(b3o[0], "x", axis=0, tiled=True)[: plan.gk]
        cv, cc = gustavson_core(
            a3v[0], a3o[0], b3v_g, b3o_g, seg[0],
            gk=plan.gk, max_a=plan.max_a, max_b=plan.max_b,
            tm=plan.tm, tn=plan.tn, nt_c=plan.s_max,
            acc_dtype=acc_dtype,
        )
        return cv[None], cc[None]

    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(P("x"),) * 5,
            out_specs=(P("x"), P("x")),
            check_vma=False,
        )
    )
    c_val_d, c_cnt_d = fn(
        jnp.asarray(plan.a3_val), jnp.asarray(plan.a3_occ),
        jnp.asarray(plan.b3_val), jnp.asarray(plan.b3_occ),
        jnp.asarray(plan.seg),
    )
    if inspect is not None:
        inspect((c_val_d, c_cnt_d))
    c_val = np.asarray(c_val_d, dtype=np.float64)
    c_cnt = np.asarray(c_cnt_d)
    keep_val = np.concatenate(
        [c_val[d, : plan.seg_counts[d]] for d in range(ndev)]
    ) if plan.ctrow.size else np.zeros((0, plan.tm, plan.tn))
    keep_cnt = np.concatenate(
        [c_cnt[d, : plan.seg_counts[d]] for d in range(ndev)]
    ) if plan.ctrow.size else np.zeros((0, plan.tm, plan.tn))

    from spgemm_tpu.ops.spgemm import _compact_to_tilemat

    return _compact_to_tilemat(
        plan.ctrow, plan.ctcol, keep_val, keep_cnt,
        (a.m, b.n), a.tm, b.tn,
    )


# --- Distributed strip path (tile-pair kernel under shard_map) ------------


def place_strip_partition(a: TileMat, b: TileMat, mesh: Mesh,
                          dtype=np.float32):
    """Decentralized operand staging: plan the partition on the host
    (pair schedule and per-device bounds), then build each device's
    padded slice of every plan array ON DEMAND, `jax.device_put` it to
    that device and free the host copy before building the next one.
    Host peak holds ONE padded shard instead of the (D, ...) stacks of
    plan_row_partition. Global arrays sharded over mesh axis "x" are
    assembled with jax.make_array_from_single_device_arrays — the
    mechanism a multi-host deployment uses for its addressable shards
    (see init_multihost). Returns (arrays, plan) for
    spgemm_sharded_strip(placed=...); the plan's stacked arrays stay
    None."""
    from jax.sharding import NamedSharding

    ndev = mesh.devices.size
    devices = list(mesh.devices.flat)
    plan = _partition(a, b, ndev)
    proc = jax.process_index()
    per_dev: dict = {name: [] for name in _DIST_ARRAYS}
    shapes = {}
    for d in range(ndev):
        if devices[d].process_index != proc:
            continue  # multi-host: build ONLY this host's shards
        host = _shard_arrays(plan, a, b, d, dtype)
        for name, arr in host.items():
            per_dev[name].append(jax.device_put(arr, devices[d]))
            shapes[name] = (ndev,) + arr.shape[1:]
        del host  # free this shard's host copy before the next one
    jax.block_until_ready(per_dev)
    sharding = NamedSharding(mesh, P("x"))
    arrays = tuple(
        jax.make_array_from_single_device_arrays(
            shapes[name], sharding, per_dev[name])
        for name in _DIST_ARRAYS)
    return arrays, plan


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> int:
    """Multi-host entry point (SURVEY.md 5's multihost_utils
    orchestration): initialize the JAX distributed runtime, after which
    `jax.devices()` spans all hosts and a Mesh over it drives the same
    shard_map paths. Every host computes the (global) pair schedule, then
    packs and places ONLY its addressable shards:

        init_multihost("host0:1234", num_processes=H, process_id=h)
        mesh = make_mesh(len(jax.devices()))
        arrays, plan = place_strip_partition(a, b, mesh)   # this host
        c = spgemm_sharded_strip(a, b, mesh, placed=(arrays, plan))

    place_strip_partition's packing loop skips devices of other
    processes (jax.make_array_from_single_device_arrays assembles the
    global array from per-host locals). The call is a no-op for a single
    process. Returns the process count."""
    import jax

    if num_processes in (None, 1) and coordinator_address is None:
        # single-process: nothing to coordinate — jax.distributed
        # requires a coordinator even for n=1, so skip entirely
        return 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    return jax.process_count()


def spgemm_sharded_strip(
    a: TileMat,
    b: TileMat,
    mesh: Mesh,
    *,
    placed=None,
    inspect=None,
) -> TileMat:
    """Distributed C = A @ B through the single-device structured route
    per shard: A tile-rows partitioned per device (pair-count balanced),
    B tiles all-gathered inside the shard_map body, and each shard's
    candidate C tiles computed by the XLA pair products (ops/strip.py).
    Occupancy is bit-packed on the device before the host sees it.

    `placed` accepts the (arrays, plan) pair from place_strip_partition
    (operands already device-resident, each host holding only its own
    shards); without it the operands are staged the same way here.
    `inspect`, when given, is called with the sharded device outputs
    before the host assembles C (the card smoke run prints where each
    output shard lives)."""
    from spgemm_tpu.ops.numeric import pair_accumulate
    from spgemm_tpu.ops.spgemm import _compact_to_tilemat
    from spgemm_tpu.ops.strip import pack_occupancy, unpack_occupancy

    ndev = mesh.devices.size
    arrays, plan = placed if placed is not None else place_strip_partition(
        a, b, mesh)
    tm, tn = a.tm, b.tn
    pack_bits = tn % 32 == 0
    s_max = plan.s_max

    def device_fn(av, ao, bv, bo, pa, pb, seg):
        bv_g = jax.lax.all_gather(bv[0], "x", axis=0, tiled=True)
        bo_g = jax.lax.all_gather(bo[0], "x", axis=0, tiled=True)
        cv, cc = pair_accumulate(av[0], ao[0], bv_g, bo_g, pa[0], pb[0],
                                 seg[0], num_segments=s_max,
                                 chunk=max(1, pa.shape[1]))
        oc = pack_occupancy(cc) if pack_bits else (cc > 0).astype(
            jnp.float32)
        return cv[None], oc[None]

    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(P("x"),) * 7,
            out_specs=(P("x"), P("x")),
            check_vma=False,
        )
    )
    v_d, occ_d = fn(*arrays)
    if inspect is not None:
        inspect((v_d, occ_d))
    if jax.process_count() > 1:
        # multi-host: the outputs are global arrays whose shards live on
        # other hosts; gather them so every host assembles the full C
        # (tests/test_multihost.py exercises this across 2 real
        # processes — pattern-static serving would keep the result
        # sharded instead of materializing it per host)
        from jax.experimental import multihost_utils

        v_d = multihost_utils.process_allgather(v_d, tiled=True)
        occ_d = multihost_utils.process_allgather(occ_d, tiled=True)
    v = np.asarray(v_d)
    occ_h = np.asarray(occ_d)
    counts = plan.seg_counts
    if plan.ctrow.size:
        keep_val = np.concatenate([v[d, : counts[d]] for d in range(ndev)])
        occ = np.concatenate([
            (unpack_occupancy(occ_h[d], tn) if pack_bits
             else occ_h[d] > 0)[: counts[d]] for d in range(ndev)])
    else:
        keep_val = np.zeros((0, tm, tn))
        occ = np.zeros((0, tm, tn), bool)
    return _compact_to_tilemat(
        plan.ctrow, plan.ctcol, keep_val.astype(np.float64),
        occ.astype(np.float32), (a.m, b.n), tm, tn,
    )


# --- Distributed ESC (unstructured engine) ---------------------------------


def spgemm_sharded_esc(a_csr, b_csr, mesh: Mesh, *, plan=None,
                       inspect=None):
    """Distributed unstructured SpGEMM through the ESC scan engine.

    The scan layout is embarrassingly parallel: rows of the (R, 128)
    product layout map to disjoint 128-slot windows of C's value array,
    so sharding R over the mesh needs NO collectives at all — each
    device reduces its own row slab (contrast with the tiled paths,
    which all-gather B). The host splits at window boundaries so no
    window's sibling rows straddle devices. Returns the CSR C.

    This is the multi-chip face of the nsparse replacement: the
    reference is single-GPU; here the unstructured engine scales the
    same way the strip path does (SURVEY.md 2.7).
    `inspect`, when given, is called with the sharded device outputs
    before the host assembles C (the card smoke run prints where each
    output shard lives)."""
    from spgemm_tpu.models.csr import CSR
    from spgemm_tpu.ops.esc import (ROW_ALIGN, build_esc_scan_plan,
                                    esc_scan_reduce)

    if plan is None:
        plan = build_esc_scan_plan(a_csr, b_csr, keep_sources=False)
    ndev = mesh.devices.size
    r_total = plan.qv.shape[0]
    if plan.num_products == 0:
        return CSR(plan.c_indptr.astype(INDEX_DTYPE), plan.c_indices,
                   np.zeros(plan.nnz_c), plan.shape)
    # shard boundaries: window-aligned, equal per device (shard_map needs
    # uniform shapes). Windows go whole to the device owning their first
    # row at stride `part`, so a device's slab holds up to `part` rows
    # plus one window's overhang.
    wr = plan.win_rowptr
    part = max(1, -(-r_total // ndev))
    max_win = int(np.diff(wr).max()) if wr.size > 1 else 0
    shard_rows = -(-(part + max_win) // ROW_ALIGN) * ROW_ALIGN
    r_pad = shard_rows * ndev
    dev_of_win = np.minimum(wr[:-1] // part, ndev - 1)
    # new row position: within-device repack (windows stay in order,
    # vectorized: per-device exclusive cumsum of window row counts)
    rows_per_win = np.diff(wr)
    csum = np.cumsum(rows_per_win) - rows_per_win
    first_w = np.searchsorted(dev_of_win, np.arange(ndev), side="left")
    base_rows = csum[np.minimum(first_w, csum.size - 1)]
    new_start = dev_of_win * shard_rows + csum - base_rows[dev_of_win]
    rows_used = np.zeros(ndev, np.int64)
    np.add.at(rows_used, dev_of_win, rows_per_win)
    if np.any(rows_used > shard_rows):
        # extremely skewed: a device overflowed its slab — fall back to
        # the single-device path (and say so: the caller would otherwise
        # report a multi-chip number for a single-chip run)
        import sys

        from spgemm_tpu.ops.esc import esc_scan_numeric, esc_scan_trim

        print("spgemm_sharded_esc: window skew overflows the per-device "
              "slab; running single-device", file=sys.stderr)
        return esc_scan_trim(plan, esc_scan_numeric(plan))
    # one fancy-indexed copy: old row index -> new row index
    old_rows = np.arange(int(wr[-1]), dtype=np.int64)
    win_of_row = np.repeat(np.arange(wr.size - 1, dtype=np.int64),
                           rows_per_win)
    new_rows = new_start[win_of_row] + (old_rows - wr[win_of_row])
    from spgemm_tpu.ops.esc import META16, meta16_plane
    src_meta = meta16_plane(plan.meta, cache_on=plan) if META16 else plan.meta
    qv = np.zeros((r_pad, 128), np.float32)
    meta = np.zeros((r_pad, 128), src_meta.dtype)
    qv[new_rows] = plan.qv[: old_rows.size]
    meta[new_rows] = src_meta[: old_rows.size]

    grows = plan.group_rows

    def device_fn(qv, meta):
        return esc_scan_reduce(qv[0], meta[0], passes=plan.passes,
                               group_rows=grows)[None]

    fn = jax.jit(jax.shard_map(
        device_fn, mesh=mesh,
        in_specs=(P("x"), P("x")), out_specs=P("x"),
        check_vma=False,
    ))
    out_d = fn(jnp.asarray(qv.reshape(ndev, shard_rows, 128)),
               jnp.asarray(meta.reshape(ndev, shard_rows, 128)))
    if inspect is not None:
        inspect((out_d,))
    out = np.asarray(out_d, np.float64).reshape(r_pad // grows, 128)

    c_val = np.zeros(plan.nnz_c, np.float64)
    if plan.nnz_c:
        # shard boundaries and window starts are ROW_ALIGN/G-aligned, so
        # dividing the group-reduced row indices by G keeps the reduceat
        sums = np.add.reduceat(out, new_start // grows, axis=0) \
            if new_start.size else out[:0]
        # reduceat sums [new_start[w], new_start[w+1]) — padding rows
        # between shards are zero, so over-summing into the last window
        # of a shard is harmless
        c_val[:] = sums.reshape(-1)[: plan.nnz_c]
    return CSR(plan.c_indptr.astype(INDEX_DTYPE), plan.c_indices,
               c_val, plan.shape)


# --- Ring (ppermute) variant: halo exchange instead of all-gather ----------


def spgemm_sharded_ring(
    a: TileMat,
    b: TileMat,
    mesh: Mesh,
    *,
    acc_dtype=jnp.float32,
    inspect=None,
) -> TileMat:
    """Distributed C = A @ B with B rotated around the ring instead of
    all-gathered: each device holds one B k-shard at a time, computes the
    partial Gustavson products for the k range it currently holds, and
    passes the shard to its neighbour with `lax.ppermute` (the north-star
    spec's halo-exchange formulation, SURVEY.md §2.7). Peak per-device B
    memory is one shard (1/D of the all-gather variant), and each step's
    compute overlaps the next rotation under XLA's scheduler.
    `inspect`, when given, is called with the sharded device outputs
    before the host assembles C (the card smoke run prints where each
    output shard lives)."""
    from spgemm_tpu.ops.gustavson import gustavson_core

    ndev = mesh.devices.size
    plan = plan_gustavson_partition(a, b, ndev)
    gk, max_a, max_b = plan.gk, plan.max_a, plan.max_b
    tm, tn = plan.tm, plan.tn
    gk_shard = plan.b3_val.shape[1]
    gk_pad = gk_shard * ndev
    s_max = plan.s_max

    # pad A slabs and the segment map over k to the sharded grid
    a3v = np.zeros((ndev, gk_pad) + plan.a3_val.shape[2:],
                   dtype=plan.a3_val.dtype)
    a3o = np.zeros_like(a3v)
    a3v[:, :gk] = plan.a3_val
    a3o[:, :gk] = plan.a3_occ
    seg = np.full((ndev, gk_pad, max_a * max_b), s_max, dtype=np.int32)
    seg[:, :gk] = plan.seg.reshape(ndev, gk, max_a * max_b)

    def device_fn(a3v, a3o, b3v, b3o, seg):
        a3v, a3o, seg = a3v[0], a3o[0], seg[0]
        bv, bo = b3v[0], b3o[0]
        me = jax.lax.axis_index("x")
        perm = [((d + 1) % ndev, d) for d in range(ndev)]

        cv = jnp.zeros((s_max, tm, tn), acc_dtype)
        cc = jnp.zeros((s_max, tm, tn), acc_dtype)
        # static unroll: ndev is a mesh constant, and the final rotation
        # (whose result would be discarded) is skipped
        for s in range(ndev):
            owner = (me + s) % ndev
            k0 = owner * gk_shard
            a3v_s = jax.lax.dynamic_slice_in_dim(a3v, k0, gk_shard, 0)
            a3o_s = jax.lax.dynamic_slice_in_dim(a3o, k0, gk_shard, 0)
            seg_s = jax.lax.dynamic_slice_in_dim(seg, k0, gk_shard, 0)
            cv_p, cc_p = gustavson_core(
                a3v_s, a3o_s, bv, bo, seg_s.reshape(-1),
                gk=gk_shard, max_a=max_a, max_b=max_b,
                tm=tm, tn=tn, nt_c=s_max, acc_dtype=acc_dtype,
            )
            cv = cv + cv_p
            cc = cc + cc_p
            if s + 1 < ndev:
                bv = jax.lax.ppermute(bv, "x", perm)
                bo = jax.lax.ppermute(bo, "x", perm)
        return cv[None], cc[None]

    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(P("x"),) * 5,
            out_specs=(P("x"), P("x")),
            check_vma=False,
        )
    )
    c_val_d, c_cnt_d = fn(
        jnp.asarray(a3v), jnp.asarray(a3o),
        jnp.asarray(plan.b3_val), jnp.asarray(plan.b3_occ),
        jnp.asarray(seg),
    )
    if inspect is not None:
        inspect((c_val_d, c_cnt_d))
    c_val = np.asarray(c_val_d, dtype=np.float64)
    c_cnt = np.asarray(c_cnt_d)
    keep_val = np.concatenate(
        [c_val[d, : plan.seg_counts[d]] for d in range(ndev)]
    ) if plan.ctrow.size else np.zeros((0, tm, tn))
    keep_cnt = np.concatenate(
        [c_cnt[d, : plan.seg_counts[d]] for d in range(ndev)]
    ) if plan.ctrow.size else np.zeros((0, tm, tn))

    from spgemm_tpu.ops.spgemm import _compact_to_tilemat

    return _compact_to_tilemat(
        plan.ctrow, plan.ctcol, keep_val, keep_cnt,
        (a.m, b.n), a.tm, b.tn,
    )


# --- Distributed Ozaki f64 path ---------------------------------------------


@dataclasses.dataclass
class OzakiDistPlan:
    ndev: int
    gk: int
    max_a: int
    max_b: int
    tm: int
    tn: int
    sa: int             # unified slice counts (max over shards)
    sb: int
    s_max: int
    a_sl: np.ndarray    # (D, Sa, gk, max_a*tm, tk) int8
    a_occ: np.ndarray   # (D, gk, max_a*tm, tk) int8
    b_sl: np.ndarray    # (D, Sb, gk_shard, tk, max_b*tn) int8 (k-sharded)
    b_occ: np.ndarray   # (D, gk_shard, tk, max_b*tn) int8
    seg: np.ndarray     # (D, gk*max_a*max_b) local segments, pad -> s_max
    seg_counts: np.ndarray
    ea: np.ndarray      # (D, rows_pad) per-shard LOCAL row scale exps
    eb: np.ndarray      # (gn*tn,) global column scale exponents
    ctrow: np.ndarray   # global C tile coords (concatenated device order)
    ctcol: np.ndarray
    ct_local: list      # per-device (local ctrow, ctcol) for the scaling


def plan_ozaki_partition(a: TileMat, b: TileMat, ndev: int) -> OzakiDistPlan:
    """Row-partition A (pair-count balanced, same policy as the
    Gustavson dist plan) and build one Ozaki slice plan per device.
    Slice counts are unified to the max over shards (shard_map needs
    identical static shapes); the padding slices are exact zeros. B is
    sliced once against its GLOBAL per-column scales (identical on every
    shard) and sharded over k, all-gathered on device."""
    from spgemm_tpu.ops.gustavson import build_gustavson_plan
    from spgemm_tpu.ops.ozaki import slice_and_pack

    k = a.tcol.astype(np.int64)
    bptr = b.tptr.astype(np.int64)
    pair_per_tile = bptr[k + 1] - bptr[k]
    pairs_per_row = np.zeros(a.gm, dtype=np.int64)
    np.add.at(pairs_per_row, a.trow, pair_per_tile)
    cum = np.cumsum(pairs_per_row)
    total = int(cum[-1]) if cum.size else 0
    bounds = np.searchsorted(cum, np.arange(1, ndev) * (total / ndev))
    row_start = (np.concatenate([[0], bounds + 1]) if ndev > 1
                 else np.array([0]))
    row_end = (np.concatenate([bounds + 1, [a.gm]]) if ndev > 1
               else np.array([a.gm]))

    shards = []
    for d in range(ndev):
        a_d = a.slice_tile_rows(int(row_start[d]), int(row_end[d]))
        base_d = build_gustavson_plan(a_d, b, dtype=np.float32,
                                      values=False)
        sl = slice_and_pack(a_d, b, base_d)
        shards.append((a_d, base_d, sl))

    gk = shards[0][1].gk
    tm, tk, tn = a.tm, a.tn, b.tn
    max_a = max(1, max(p.max_a for _, p, _ in shards))
    max_b = max(1, max(p.max_b for _, p, _ in shards))
    s_max = max(1, max(p.nt_c for _, p, _ in shards))
    sa = max(s[4] for _, _, s in shards)
    sb = max(s[5] for _, _, s in shards)

    a_sl = np.zeros((ndev, sa, gk, max_a * tm, tk), np.int8)
    a_occ = np.zeros((ndev, gk, max_a * tm, tk), np.int8)
    seg = np.full((ndev, gk * max_a * max_b), s_max, dtype=np.int32)
    ea = np.zeros((ndev, a.gm * tm), np.int64)
    ctrow_parts, ctcol_parts, ct_local = [], [], []
    for d, (a_d, p, (asl_d, _, ea_d, _, sa_d, _)) in enumerate(shards):
        a_sl[d, :sa_d, :, : p.max_a * tm] = asl_d
        a_occ[d, :, : p.max_a * tm] = p.a3_occ.astype(np.int8)
        src = p.seg.reshape(gk, p.max_a, p.max_b)
        dst = seg[d].reshape(gk, max_a, max_b)
        dst[:, : p.max_a, : p.max_b] = np.where(src == p.nt_c, s_max, src)
        # ea_d is LOCAL to the shard (slice_tile_rows rebases rows)
        ea[d, : ea_d.size] = ea_d
        ctrow_parts.append(p.ctrow + int(row_start[d]))
        ctcol_parts.append(p.ctcol)
        ct_local.append((np.asarray(p.ctrow), np.asarray(p.ctcol)))

    # B slices: global column scales make every shard's B stack
    # identical — take shard 0's, pad Sb/max_b, shard over k
    p0 = shards[0][1]
    bsl0 = shards[0][2][1]                       # (sb0, gk, tk, mb0*tn)
    eb = shards[0][2][3]
    gk_shard = cdiv(gk, ndev)
    b_sl = np.zeros((ndev, sb, gk_shard, tk, max_b * tn), np.int8)
    b_occ = np.zeros((ndev, gk_shard, tk, max_b * tn), np.int8)
    bsrc = np.zeros((sb, gk_shard * ndev, tk, max_b * tn), np.int8)
    bsrc[: bsl0.shape[0], :gk, :, : p0.max_b * tn] = bsl0
    osrc = np.zeros((gk_shard * ndev, tk, max_b * tn), np.int8)
    osrc[:gk, :, : p0.max_b * tn] = p0.b3_occ.astype(np.int8)
    for d in range(ndev):
        b_sl[d] = bsrc[:, d * gk_shard:(d + 1) * gk_shard]
        b_occ[d] = osrc[d * gk_shard:(d + 1) * gk_shard]

    return OzakiDistPlan(
        ndev=ndev, gk=gk, max_a=max_a, max_b=max_b, tm=tm, tn=tn,
        sa=sa, sb=sb, s_max=s_max,
        a_sl=a_sl, a_occ=a_occ, b_sl=b_sl, b_occ=b_occ, seg=seg,
        seg_counts=np.array([p.nt_c for _, p, _ in shards]),
        ea=ea, eb=eb,
        ctrow=np.concatenate(ctrow_parts) if shards else
        np.zeros(0, INDEX_DTYPE),
        ctcol=np.concatenate(ctcol_parts) if shards else
        np.zeros(0, INDEX_DTYPE),
        ct_local=ct_local,
    )


def spgemm_sharded_ozaki(a: TileMat, b: TileMat, mesh: Mesh, *,
                         inspect=None):
    """Distributed EXACT-f64 C = A @ B over `mesh` (axis "x") through
    the Ozaki-slice engine (ops/ozaki.py): A tile-rows partitioned per
    device, int8 B slice stacks sharded over the inner dimension and
    all-gathered inside the shard_map body, C tiles
    owner-computed (no cross-device reduction). The f64 scaling epilogue
    runs on host per shard. Completes the engines' SPMD coverage: the
    reference has no f64-distributed counterpart (it is single-GPU,
    SURVEY 2.7).
    `inspect`, when given, is called with the sharded device outputs
    before the host assembles C (the card smoke run prints where each
    output shard lives)."""
    from spgemm_tpu.ops.ozaki import ozaki_core

    ndev = mesh.devices.size
    plan = plan_ozaki_partition(a, b, ndev)

    def device_fn(a_sl, a_occ, b_sl, b_occ, seg):
        bsl_g = jax.lax.all_gather(
            b_sl[0], "x", axis=1, tiled=True)[:, : plan.gk]
        bocc_g = jax.lax.all_gather(
            b_occ[0], "x", axis=0, tiled=True)[: plan.gk]
        # scatter combine (per-shard perm/bounds would need uniform
        # padding across shards for marginal benefit — the dist path's
        # wall is the all-gather, not the combine)
        dummy = jnp.zeros(1, jnp.int32)
        h, m, l, cnt = ozaki_core(
            a_sl[0], bsl_g, a_occ[0], bocc_g, seg[0], dummy, dummy,
            gk=plan.gk, max_a=plan.max_a, max_b=plan.max_b,
            tm=plan.tm, tn=plan.tn, nt_c=plan.s_max,
            sa=plan.sa, sb=plan.sb, combine="scatter")
        return h[None], m[None], l[None], cnt[None]

    fn = jax.jit(
        jax.shard_map(
            device_fn, mesh=mesh,
            in_specs=(P("x"),) * 5,
            out_specs=(P("x"), P("x"), P("x"), P("x")),
            check_vma=False,
        )
    )
    h_d, m_d, l_d, cnt_d = fn(
        jnp.asarray(plan.a_sl), jnp.asarray(plan.a_occ),
        jnp.asarray(plan.b_sl), jnp.asarray(plan.b_occ),
        jnp.asarray(plan.seg),
    )
    if inspect is not None:
        inspect((h_d, m_d, l_d, cnt_d))
    h_np = np.asarray(h_d, np.float64)
    m_np = np.asarray(m_d, np.float64)
    l_np = np.asarray(l_d, np.float64)
    cnt = np.asarray(cnt_d)

    # host epilogue: per-shard f64 scaling (LOCAL row scales, global
    # column scales), then global compaction
    vals, cnts = [], []
    for d in range(ndev):
        nc = int(plan.seg_counts[d])
        if nc == 0:
            continue
        v = h_np[d, :nc] + m_np[d, :nc] + l_np[d, :nc]
        ctr_l, ctc_l = plan.ct_local[d]
        er = plan.ea[d].reshape(-1, plan.tm)[ctr_l.astype(np.int64)]
        ec = plan.eb.reshape(-1, plan.tn)[ctc_l.astype(np.int64)]
        ex = (er[:, :, None] + ec[:, None, :] - 14).astype(np.int64)
        vals.append(np.ldexp(v, ex))
        cnts.append(cnt[d, :nc])

    from spgemm_tpu.ops.spgemm import _compact_to_tilemat

    keep_val = (np.concatenate(vals) if vals
                else np.zeros((0, plan.tm, plan.tn)))
    keep_cnt = (np.concatenate(cnts) if cnts
                else np.zeros((0, plan.tm, plan.tn), np.int32))
    return _compact_to_tilemat(
        plan.ctrow, plan.ctcol, keep_val, keep_cnt,
        (a.m, b.n), a.tm, b.tn,
    )
