"""Distributed (multi-chip) lambda/eta assembly over a device mesh.

The reference is single-process (SURVEY.md P6: no MPI/NCCL anywhere in its
tree); this is the new capability this build adds.  Design:

  * edges are the data-parallel axis: each device holds a 1/n slice of every
    edge type's arrays (measurements, informations, slot indices, segment
    ids) — the analogue of the reference's OpenMP ``For_Each_Parallel`` over
    edge pools (reference include/slam/FlatSystem.h:932), scaled across chips;
  * every shard computes its partial block sums with the same batched
    kernels + ``segment_sum`` used on one chip, then one ``psum`` over the
    mesh reduces lambda/eta into replicated arrays (NCCL all-reduce over
    NVLink between the cards of a host);
  * the (small, replicated) solve runs identically on every device, so no
    gather is needed before the vertex update.

Padding: edge counts are padded to a multiple of the mesh size with zero
*information* matrices — padded edges contribute exactly zero to every sum
(their H = J^T 0 J) while keeping gathers in-bounds (slot ids clamp to 0).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from slam_plus_plus_tpu.assembly.assembler import Assembler, BlockSystem


def make_edge_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the edge-parallel axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("edges",))


def _pad_to(x: jnp.ndarray, n: int, fill=0):
    pad = n - x.shape[0]
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, widths, constant_values=fill)


class DistributedAssembler(Assembler):
    """Assembler whose numeric phase shards edges over a mesh.

    Drop-in replacement: ``assemble``/``chi2`` run under ``shard_map`` with a
    ``psum`` reduction; the BlockSystem it returns is replicated.
    """

    def __init__(self, system, mesh: Mesh, config=None, dtype=None):
        import dataclasses
        from slam_plus_plus_tpu.config import SolverConfig
        self.mesh = mesh
        self.n_shards = mesh.devices.size
        # edge shards are arbitrary slices — the uniform [Nl, M] layout's
        # reshape reductions assume the whole padded array on one device
        config = dataclasses.replace(config or SolverConfig(),
                                     edge_layout="flat")
        super().__init__(system, config, dtype)
        # shard-local contribution chunks are partial sums: the permutation-
        # gather shortcut does not apply (psum completes the reduction)
        self._pp_gather = False
        self._pl_gather = False
        self._shard_edge_data()
        in_specs = (P(), self._edge_specs)
        self._assemble_jit = jax.jit(
            jax.shard_map(self._dist_sums, mesh=mesh,
                          in_specs=in_specs, out_specs=P(),
                          check_vma=False))
        self._chi2_dist_jit = jax.jit(
            jax.shard_map(self._dist_chi2, mesh=mesh,
                          in_specs=in_specs, out_specs=P(),
                          check_vma=False))
        self._finalize_jit = jax.jit(self._finalize)

    def _shard_edge_data(self):
        """Pad edge arrays to a multiple of the mesh size (zero-information
        padding) and record their PartitionSpecs."""
        n = self.n_shards
        new_data = {}
        specs = {}
        for name, data in self.edge_data.items():
            E = data["z"].shape[0]
            Epad = ((E + n - 1) // n) * n
            new_data[name] = dict(
                z=_pad_to(data["z"], Epad),
                info=_pad_to(data["info"], Epad),           # zero info: no-op edges
                slot_local=tuple(_pad_to(x, Epad) for x in data["slot_local"]),
                slot_cslot=tuple(_pad_to(x, Epad) for x in data["slot_cslot"]),
                pp_seg=tuple(_pad_to(x, Epad) for x in data["pp_seg"]),
                pp_swap=tuple(_pad_to(x, Epad) for x in data["pp_swap"]),
                pl_seg=tuple(_pad_to(x, Epad) for x in data["pl_seg"]),
            )
            specs[name] = jax.tree.map(lambda _: P("edges"), new_data[name])
        self.edge_data = new_data
        self._edge_specs = specs

    # inside shard_map: identical single-chip kernels on the local slice,
    # then one psum over the mesh
    def _dist_sums(self, states, edge_data):
        pp, pl, ll, eta_p, eta_l, chi2, max_hdiag = self._edge_sums(
            states, edge_data)
        pp, pl, ll, eta_p, eta_l, chi2 = jax.lax.psum(
            (pp, pl, ll, eta_p, eta_l, chi2), "edges")
        max_hdiag = jax.lax.pmax(max_hdiag, "edges")
        return pp, pl, ll, eta_p, eta_l, chi2, max_hdiag

    def _dist_chi2(self, states, edge_data):
        return jax.lax.psum(self._chi2_impl(states, edge_data), "edges")

    def assemble(self, states) -> BlockSystem:
        sums = self._assemble_jit(states, self.edge_data)
        return self._finalize_jit(*sums)

    def chi2(self, states):
        return self._chi2_dist_jit(states, self.edge_data)


class DistributedSchurSolver:
    """Schur elimination with the panel products sharded over the mesh.

    The SC = Hpp - sum_l W_l U_l^T accumulation dominates BA solve FLOPs
    (reference: the two SpDGEMMs, LinearSolver_Schur.h:1744-1767, GPU path
    LinearSolver_Schur_GPU.cpp:2190); here each device owns a contiguous
    slice of the (column-sorted) landmark blocks, builds its partial dense
    panels locally from the REPLICATED BlockSystem, and one psum over NVLink
    reduces the partial SC.  The small reduced solve + landmark backsub run
    replicated (same reasoning as the reference's dense-Schur default).

    This distributes the reference-equivalent compute 1/n per chip; the
    collective moves one [nred, nred] array per solve.
    """

    def __init__(self, asm, mesh: Mesh):
        from slam_plus_plus_tpu.ops import planar as _planar
        self.asm = asm
        self.mesh = mesh
        self.n_shards = mesh.devices.size
        if asm.Nl == 0 or asm.Kpl == 0:
            raise ValueError("Schur solver requires an eliminated class")
        Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
        self.n_reduced = Np * Bp

        n = self.n_shards
        order = np.argsort(asm.pl_cols, kind="stable")
        sorted_cols = asm.pl_cols[order]
        sorted_rows = asm.pl_rows[order]
        Nl_pad = ((Nl + n - 1) // n) * n
        self.lm_per_shard = Nl_pad // n
        # shard boundaries in the sorted block arrays
        starts = np.searchsorted(sorted_cols,
                                 np.arange(n + 1) * self.lm_per_shard)
        M = int((starts[1:] - starts[:-1]).max())
        self.blocks_per_shard = M

        # per-shard padded index/mask tables [n, M]
        sel = np.zeros((n, M), dtype=np.int64)
        mask = np.zeros((n, M))
        rel_col = np.zeros((n, M), dtype=np.int64)
        for si in range(n):
            lo, hi = starts[si], starts[si + 1]
            k = hi - lo
            sel[si, :k] = order[lo:hi]
            mask[si, :k] = 1.0
            rel_col[si, :k] = sorted_cols[lo:hi] - si * self.lm_per_shard
        self._sel = jnp.asarray(sel)
        self._mask = jnp.asarray(mask)
        self._rel = jnp.asarray(rel_col)
        # flat panel indices per ORIGINAL block id, assuming chunk-relative
        # column 0 (the shard adds rel_col * Bl)
        self._panel_base = jnp.asarray(_planar.scatter_flat_indices(
            asm.pl_rows, np.zeros_like(asm.pl_cols), Bp, Bl,
            row_stride=self.lm_per_shard * Bl))
        # reuse the single-chip solver for dense Hpp scatter + backsub
        from slam_plus_plus_tpu.linalg.schur import SchurSolver
        self._single = SchurSolver(asm)

        shard_ids = jnp.arange(n)
        in_specs = (P(), P(), P("edges"))
        self._sc_partial = jax.jit(jax.shard_map(
            self._partial_sc, mesh=mesh, in_specs=in_specs, out_specs=P(),
            check_vma=False))
        self._solve_jit = jax.jit(self._solve_impl)
        self._shard_ids = shard_ids

    def _partial_sc(self, u, w, shard_id):
        """Inside shard_map: this shard's panel product, psum'd."""
        from slam_plus_plus_tpu.ops import planar as _planar
        asm = self.asm
        Bp, Bl = asm.Bp, asm.Bl
        si = shard_id[0]
        selg = self._sel[si]
        maskg = self._mask[si][:, None].astype(u.dtype)
        idx = self._panel_base[selg] + (self._rel[si] * Bl)[:, None]
        nred = self.n_reduced
        panel_elems = nred * self.lm_per_shard * Bl

        def build(vals):
            p = jnp.zeros((panel_elems,), dtype=u.dtype)
            return p.at[idx.reshape(-1)].add(vals.reshape(-1)).reshape(
                nred, self.lm_per_shard * Bl)

        up = build(u[selg] * maskg)
        wp = build(w[selg] * maskg)
        sc_part = -(wp @ up.T)
        return jax.lax.psum(sc_part, "edges")

    def _solve_impl(self, bs):
        from slam_plus_plus_tpu.ops import planar as _planar
        asm = self.asm
        Np, Bp, Nl, Bl = asm.Np, asm.Bp, asm.Nl, asm.Bl
        sng = self._single
        c_inv = _planar.binv(bs.ll_blocks, Bl)
        u = bs.pl_blocks
        w = _planar.bmm(u, c_inv[sng._pl_cols_dev], Bp, Bl, Bl)
        w_eta = _planar.bmv(w, bs.eta_l[sng._pl_cols_dev], Bp, Bl)
        rhs_p = bs.eta_p - jax.ops.segment_sum(
            w_eta, sng._pl_rows_dev, num_segments=Np)
        sc = sng._dense_pp(bs.pp_blocks) + self._sc_partial(
            u, w, self._shard_ids)
        L = jnp.linalg.cholesky(sc)
        nred = self.n_reduced
        y = jax.scipy.linalg.solve_triangular(L, rhs_p.reshape(nred),
                                              lower=True)
        dx_p = jax.scipy.linalg.solve_triangular(L.T, y,
                                                 lower=False).reshape(Np, Bp)
        ut_dx = _planar.bmv_At(u, dx_p[sng._pl_rows_dev], Bp, Bl)
        rhs_l = bs.eta_l - jax.ops.segment_sum(
            ut_dx, sng._pl_cols_dev, num_segments=Nl)
        dx_l = _planar.bmv(c_inv, rhs_l, Bl, Bl)
        return dx_p, dx_l

    def solve(self, bs):
        return self._solve_jit(bs)
