"""phylint CLI: statically lint the execution trees of shipped configs.

Counterpart: ``tools/phylint.py``, inside the package, with the same
flags.  Dryrun-traces every architecture in ``repro_torch.configs`` (no
devices, no parameters: the builders in
``repro_torch.analysis.trace_builders`` mirror the host trees
``Session.train`` / ``Session.serve`` / ``Session.serve_stream`` would
build) and runs the PHY001-PHY006 static passes (DESIGN.md §12) over
each graph, so a config or loop change that introduces a cycle, an
orphaned promise, a lane inversion, a dead node or a donation-after-use
hazard fails ``--strict``.

    python -m repro_torch.analysis.phylint --all-configs --strict
    python -m repro_torch.analysis.phylint --arch qwen3-4b --variant ddp
    python -m repro_torch.analysis.phylint --arch qwen3-4b --variant serve
    python -m repro_torch.analysis.phylint --list-rules
"""
from __future__ import annotations

import argparse
import sys

#: Plan variants traced per architecture: standard single-locality
#: training, the serving trees (wave serve and the continuous-batching
#: gateway, DESIGN.md §14), fabric-DDP shadow and SPMD shadow (DESIGN.md
#: §10-§11).  The DDP and SPMD builders mirror the driver's tree, so
#: localities=2 is representative.  ``workloads`` filters the
#: ``plan_traces`` output so that no tree is linted twice across variants.
VARIANTS = {
    "standard": {"plan": dict(), "workloads": ("train", "step-contract")},
    "serve": {"plan": dict(),
              "workloads": ("serve", "gateway", "gateway-replicas")},
    "ddp": {"plan": dict(ddp=True, localities=2), "workloads": None},
    "spmd": {"plan": dict(spmd=True, localities=2), "workloads": None},
}


def iter_graphs(arch_ids, variants):
    """``(label, LintGraph)`` for every arch, variant and workload."""
    from ..frontend.plan import Plan
    from .trace_builders import plan_traces

    for aid in arch_ids:
        for vname in variants:
            spec = VARIANTS[vname]
            plan = Plan(arch=aid, tiny=True, device="cpu", **spec["plan"])
            keep = spec["workloads"]
            for wname, graph in plan_traces(plan).items():
                if keep is not None and wname not in keep:
                    continue
                yield f"{aid}/{vname}/{wname}", graph


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="phylint", description=__doc__.splitlines()[0])
    ap.add_argument("--all-configs", action="store_true",
                    help="lint every architecture in repro_torch.configs")
    ap.add_argument("--arch", action="append", default=[],
                    help="lint one architecture id (repeatable)")
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS),
                    help="restrict to plan variants (default: all)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any finding")
    ap.add_argument("--strict-lanes", action="store_true",
                    help="also flag the PREFETCH->COMPUTE feed edge "
                         "(PHY003 without the exemption)")
    ap.add_argument("--fanin-threshold", type=int, default=None,
                    help="override the PHY006 fan-in threshold")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    from . import lint as lint_mod
    from .sanitize import DYNAMIC_RULES

    if args.list_rules:
        for rid, desc in sorted({**lint_mod.STATIC_RULES,
                                 **DYNAMIC_RULES}.items()):
            print(f"{rid}  {desc}")
        return 0

    from ..configs import ARCH_IDS

    arch_ids = list(ARCH_IDS) if args.all_configs or not args.arch \
        else args.arch
    unknown = [a for a in arch_ids if a not in ARCH_IDS]
    if unknown:
        ap.error(f"unknown arch id(s): {', '.join(unknown)} "
                 f"(known: {', '.join(ARCH_IDS)})")
    variants = args.variant or sorted(VARIANTS)

    kwargs = {"strict_lanes": args.strict_lanes}
    if args.fanin_threshold is not None:
        kwargs["fanin_threshold"] = args.fanin_threshold

    graphs = findings = 0
    for label, graph in iter_graphs(arch_ids, variants):
        graphs += 1
        found = lint_mod.lint(graph, **kwargs)
        findings += len(found)
        for f in found:
            where = f" [{', '.join(f.nodes)}]" if f.nodes else ""
            hint = f"  ({f.src})" if f.src else ""
            print(f"{label}: {f.rule}: {f.message}{where}{hint}")
    status = "clean" if findings == 0 else f"{findings} finding(s)"
    print(f"phylint: {graphs} graph(s) over {len(arch_ids)} config(s): "
          f"{status}")
    return 1 if (findings and args.strict) else 0


if __name__ == "__main__":
    sys.exit(main())
