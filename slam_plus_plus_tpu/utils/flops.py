"""Analytic FLOP accounting for the solver pipeline.

Reference analogue: the FLOP-counting instrumented scalar + CSparse clone
(reference include/sparse_flops/Instrument.h:40,131, cts.hpp) used to report
exact operation counts.  On the device the compiled program's cost is known
to XLA, so instrumentation is analytic: per-stage FLOP formulas from the static
problem structure, plus XLA's own cost analysis of the jitted computations
when available.
"""

from __future__ import annotations

from typing import Dict


def assembly_flops(asm) -> Dict[str, float]:
    """Per-iteration lambda/eta assembly FLOPs from the structure."""
    total = 0.0
    detail = {}
    for plan in asm.plans:
        E = plan.E
        m = None
        from slam_plus_plus_tpu.models.types import EDGE_TYPES
        et = EDGE_TYPES[plan.name]
        m = et.residual_dim
        per_edge = 0.0
        for k, t in enumerate(plan.slot_types):
            B = asm.Bp if plan.slot_class[k] == "p" else asm.Bl
            per_edge += 2.0 * m * m * B      # J^T info
            per_edge += 2.0 * m * B          # g = J^T (info r)
        n_pairs = len(plan.pp_contribs) + len(plan.pl_contribs) + \
            sum(1 for c in plan.slot_class if c == "l")
        per_edge += n_pairs * 2.0 * asm.Bp * m * asm.Bp  # H products (upper bound)
        detail[plan.name] = E * per_edge
        total += E * per_edge
    detail["total"] = total
    return detail


def schur_flops(asm, chunk=None) -> Dict[str, float]:
    """Schur elimination FLOPs: C^-1, W, panel GEMMs, reduced Cholesky."""
    Np, Bp, Nl, Bl, Kpl = asm.Np, asm.Bp, asm.Nl, asm.Bl, asm.Kpl
    nred = Np * Bp
    d = {
        "c_inv": Nl * (Bl ** 3) * 2.0,
        "w": Kpl * 2.0 * Bp * Bl * Bl,
        "sc_gemm": 2.0 * nred * nred * Nl * Bl,
        "chol": nred ** 3 / 3.0,
        "backsub": Kpl * 4.0 * Bp * Bl + Nl * 2.0 * Bl * Bl,
    }
    d["total"] = sum(d.values())
    return d


def xla_cost(fn_jitted, *args) -> Dict[str, float]:
    """XLA's own cost analysis of a compiled function (flops/bytes)."""
    try:
        lowered = fn_jitted.lower(*args)
        compiled = lowered.compile()
        ca = compiled.cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        return {k: float(v) for k, v in ca.items()
                if k in ("flops", "bytes accessed", "optimal_seconds")}
    except Exception:
        return {}
