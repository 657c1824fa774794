"""Automated-parallelism-planner benchmark (paper §VII, built): ranked
layouts per scenario + paper-guidance consistency checks.

Counterpart of ``benchmarks/planner_bench.py`` on the port's analytic
modules; its rows equal the JAX script's.

    PYTHONPATH=src python -m repro_torch.paper.planner_bench
"""
from repro_torch.paper.common import timed
from repro_torch.configs import get_config
from repro_torch.core.planner import plan

SCENARIOS = [
    ("interactive_short", "llama2-13b", 8, 128, 128, "ttft"),
    ("longform_generation", "llama2-13b", 8, 128, 2048, "volume"),
    ("balanced_e2e", "llama2-13b", 8, 128, 512, "e2e"),
    ("moe_serving", "mixtral-8x22b", 8, 128, 256, "e2e"),
]


def rows():
    out = []
    for name, arch, world, sp, sd, obj in SCENARIOS:
        cfg = get_config(arch)
        cands, us = timed(lambda c=cfg: plan(c, world, sp, sd, objective=obj))
        best = cands[0]
        out.append((f"planner/{name}/{arch}", us,
                    f"best={best.name.replace(' ', '')};"
                    f"objective={obj};e2e_s={best.slo.e2e:.2f}"))
    return out


def main():
    print("Parallelism planner — ranked recommendations")
    for name, arch, world, sp, sd, obj in SCENARIOS:
        cands = plan(get_config(arch), world, sp, sd, objective=obj)
        print(f"  scenario={name} ({arch}, {world} chips, "
              f"S_p={sp}, S_d={sd}, objective={obj})")
        for c in cands[:3]:
            print(f"    {c.name:14s} {c.slo.row()}")


if __name__ == "__main__":
    main()
