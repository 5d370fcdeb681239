"""Decomposition visualization dumps.

Equivalent of the reference's Preconditioner::Visualize /
SchurPreconditioner::Visualize (reference
src/HYMLS_Preconditioner.cpp:753-779,
src/HYMLS_SchurPreconditioner.cpp:1624-1652): writes the per-level
domain decomposition (interior groups, separator groups, Vsums) in the
same MATLAB-readable cell format, so the reference's plotting scripts
(reference matlab/) work unchanged.
"""
from __future__ import annotations


def visualize(precond, path: str) -> None:
    """Dump all levels of the decomposition to a .m file."""
    with open(path, "w") as f:
        f.write("% hymls_tpu domain decomposition dump\n")
        for lev, hier in enumerate(precond.hierarchies):
            f.write(f"%% level {lev}\n")
            for sd in range(hier.num_subdomains):
                f.write(f"p{{{lev + 1}}}{{1}}.groups{{{sd + 1}}} = {{")
                f.write("[" + ",".join(str(int(g)) for g in
                                       hier.interior[sd]) + "]")
                for gi in hier.sd_groups[sd]:
                    f.write(",...\n[" + ",".join(
                        str(int(g)) for g in hier.groups[gi].nodes) + "]")
                f.write("};\n")
            vsums = hier.vsum_nodes()
            f.write(f"p{{{lev + 1}}}{{1}}.vsums = ["
                    + ",".join(str(int(v)) for v in vsums) + "];\n")
