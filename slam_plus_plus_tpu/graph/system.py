"""GraphSystem — the typed columnar factor-graph container.

Reference analogue: CFlatSystem (reference include/slam/FlatSystem.h:1915)
with its per-type multipools, auto vertex creation on edge insert
(r_Get_Vertex, FlatSystem.h:2457) and r_Add_Edge (FlatSystem.h:2651).

Accelerator-first inversion: instead of pools of objects with facade
dispatch, each vertex/edge type owns *columnar numpy arrays* with amortized
capacity doubling.  The device pipeline consumes these arrays directly (one
``vmap``-batched residual per edge type), so "type erasure" costs nothing:
there are as many traced functions as edge types, not as many as edges.

Host-side by design: graph building is sequential/IO-bound; the device sees
only the padded snapshots taken by the assembly layer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from slam_plus_plus_tpu.models.types import EDGE_TYPES, VERTEX_TYPES, EdgeType, VertexType


class _VertexStore:
    def __init__(self, vtype: VertexType):
        self.vtype = vtype
        self.states = np.zeros((16, vtype.state_dim), dtype=np.float64)
        self.n = 0
        self.global_ids: List[int] = []

    def append(self, state: np.ndarray) -> int:
        if self.n == self.states.shape[0]:
            self.states = np.concatenate([self.states, np.zeros_like(self.states)])
        self.states[self.n] = state
        self.n += 1
        return self.n - 1

    @property
    def data(self) -> np.ndarray:
        return self.states[:self.n]


class _EdgeStore:
    def __init__(self, etype: EdgeType):
        self.etype = etype
        cap = 16
        self.vertex_ids = np.zeros((cap, etype.arity), dtype=np.int64)
        self.measurements = np.zeros((cap, etype.measurement_dim), dtype=np.float64)
        self.informations = np.zeros(
            (cap, etype.residual_dim, etype.residual_dim), dtype=np.float64)
        self.n = 0

    def append(self, vertex_ids, z, info) -> int:
        if self.n == self.vertex_ids.shape[0]:
            self.vertex_ids = np.concatenate([self.vertex_ids, np.zeros_like(self.vertex_ids)])
            self.measurements = np.concatenate([self.measurements, np.zeros_like(self.measurements)])
            self.informations = np.concatenate([self.informations, np.zeros_like(self.informations)])
        self.vertex_ids[self.n] = vertex_ids
        self.measurements[self.n] = z
        self.informations[self.n] = info
        self.n += 1
        return self.n - 1


class GraphSystem:
    """Factor graph with typed columnar storage and auto vertex creation."""

    def __init__(self):
        self.vertex_stores: Dict[str, _VertexStore] = {}
        self.edge_stores: Dict[str, _EdgeStore] = {}
        # global vertex id -> (type name, local index)
        self.vertex_directory: Dict[int, Tuple[str, int]] = {}
        # insertion order of global ids = the solver's block ordering
        # (reference: order of appearance in the flat system's pools)
        self.vertex_order: List[int] = []
        self._edge_insert_log: List[Tuple[str, int]] = []  # (edge type, local idx)

    # ---- vertices ------------------------------------------------------

    def add_vertex(self, global_id: int, type_name: str, state) -> None:
        """Explicit vertex insertion (a VERTEX_* line)."""
        if global_id in self.vertex_directory:
            # re-declaration updates the initial state in place (datasets may
            # list a vertex after an edge already auto-created it)
            tname, li = self.vertex_directory[global_id]
            self.vertex_stores[tname].states[li] = np.asarray(state, dtype=np.float64)
            return
        store = self.vertex_stores.setdefault(type_name, _VertexStore(VERTEX_TYPES[type_name]))
        li = store.append(np.asarray(state, dtype=np.float64))
        store.global_ids.append(global_id)
        self.vertex_directory[global_id] = (type_name, li)
        self.vertex_order.append(global_id)

    def has_vertex(self, global_id: int) -> bool:
        return global_id in self.vertex_directory

    def vertex_state(self, global_id: int) -> np.ndarray:
        tname, li = self.vertex_directory[global_id]
        return self.vertex_stores[tname].states[li]

    def set_vertex_state(self, global_id: int, state) -> None:
        tname, li = self.vertex_directory[global_id]
        self.vertex_stores[tname].states[li] = state

    # ---- edges ---------------------------------------------------------

    def add_edge(self, type_name: str, vertex_ids: Sequence[int], z, info) -> None:
        """Insert an edge, auto-creating missing vertices via the edge type's
        initializer (reference r_Get_Vertex semantics)."""
        etype = EDGE_TYPES[type_name]
        vertex_ids = list(vertex_ids)
        assert len(vertex_ids) == etype.arity

        missing = [vid for vid in vertex_ids if vid not in self.vertex_directory]
        if missing:
            existing = tuple(
                self.vertex_state(vid) if vid in self.vertex_directory else None
                for vid in vertex_ids)
            if etype.initializer is None:
                raise ValueError(
                    f"edge {type_name}: vertices {missing} missing and no initializer")
            new_states = etype.initializer(existing, np.asarray(z, dtype=np.float64))
            for slot, vid in enumerate(vertex_ids):
                if vid not in self.vertex_directory:
                    self.add_vertex(vid, etype.vertex_types[slot], new_states[slot])

        # type check existing vertices against the edge's expected slots
        for slot, vid in enumerate(vertex_ids):
            tname, _ = self.vertex_directory[vid]
            if tname != etype.vertex_types[slot]:
                raise TypeError(
                    f"edge {type_name} slot {slot}: vertex {vid} has type "
                    f"{tname}, expected {etype.vertex_types[slot]}")

        store = self.edge_stores.setdefault(type_name, _EdgeStore(etype))
        li = store.append(np.asarray(vertex_ids, dtype=np.int64),
                          np.asarray(z, dtype=np.float64),
                          np.asarray(info, dtype=np.float64))
        self._edge_insert_log.append((type_name, li))

    # ---- bulk insertion (native-parser fast path) ----------------------

    def bulk_add_vertices(self, type_name: str, global_ids: np.ndarray,
                          states: np.ndarray) -> None:
        """Append many vertices of one type at once (ids must be new)."""
        store = self.vertex_stores.setdefault(
            type_name, _VertexStore(VERTEX_TYPES[type_name]))
        n_new = len(global_ids)
        need = store.n + n_new
        if need > store.states.shape[0]:
            cap = max(need, store.states.shape[0] * 2)
            grown = np.zeros((cap, store.states.shape[1]), dtype=np.float64)
            grown[:store.n] = store.states[:store.n]
            store.states = grown
        store.states[store.n:store.n + n_new] = states
        base = store.n
        store.n += n_new
        for k, gid in enumerate(global_ids):
            gid = int(gid)
            store.global_ids.append(gid)
            self.vertex_directory[gid] = (type_name, base + k)
            self.vertex_order.append(gid)

    def bulk_add_edges(self, type_name: str, vertex_ids: np.ndarray,
                       z: np.ndarray, info: np.ndarray) -> None:
        """Append many edges of one type at once.  All referenced vertices
        must already exist (no auto-creation on the bulk path)."""
        etype = EDGE_TYPES[type_name]
        store = self.edge_stores.setdefault(type_name, _EdgeStore(etype))
        E = len(vertex_ids)
        need = store.n + E
        if need > store.vertex_ids.shape[0]:
            cap = max(need, store.vertex_ids.shape[0] * 2)

            def grow(a, shape):
                g = np.zeros((cap,) + shape, dtype=a.dtype)
                g[:store.n] = a[:store.n]
                return g
            store.vertex_ids = grow(store.vertex_ids, (etype.arity,))
            store.measurements = grow(store.measurements,
                                      (etype.measurement_dim,))
            store.informations = grow(store.informations,
                                      (etype.residual_dim, etype.residual_dim))
        store.vertex_ids[store.n:store.n + E] = vertex_ids
        store.measurements[store.n:store.n + E] = z
        store.informations[store.n:store.n + E] = info
        base = store.n
        store.n += E
        self._edge_insert_log.extend(
            (type_name, base + k) for k in range(E))

    # ---- queries -------------------------------------------------------

    @property
    def num_vertices(self) -> int:
        return len(self.vertex_order)

    @property
    def num_edges(self) -> int:
        return len(self._edge_insert_log)

    def block_index(self, global_id: int) -> int:
        """Block (column) index of a vertex in the solver ordering."""
        return self._block_of()[global_id]

    def _block_of(self) -> Dict[int, int]:
        if getattr(self, "_block_cache_n", -1) != len(self.vertex_order):
            self._block_cache = {g: i for i, g in enumerate(self.vertex_order)}
            self._block_cache_n = len(self.vertex_order)
        return self._block_cache

    def tangent_offsets(self) -> Tuple[np.ndarray, int]:
        """Per-vertex tangent-space offsets in insertion order; returns
        (offsets[num_vertices], total_tangent_dim)."""
        dims = np.array([
            VERTEX_TYPES[self.vertex_directory[g][0]].tangent_dim
            for g in self.vertex_order], dtype=np.int64)
        offsets = np.zeros(len(dims), dtype=np.int64)
        if len(dims) > 1:
            offsets[1:] = np.cumsum(dims)[:-1]
        total = int(dims.sum()) if len(dims) else 0
        return offsets, total

    def dump(self, path: str) -> None:
        """Write vertex states in insertion order, one line per vertex
        (reference CFlatSystem::Dump -> solution.txt)."""
        with open(path, "w") as f:
            for g in self.vertex_order:
                state = self.vertex_state(g)
                f.write(" ".join(f"{x:.10f}" for x in state) + "\n")

    def summary(self) -> str:
        v = {t: s.n for t, s in self.vertex_stores.items()}
        e = {t: s.n for t, s in self.edge_stores.items()}
        return f"GraphSystem(vertices={v}, edges={e})"
