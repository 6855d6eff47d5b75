#!/usr/bin/env python3
"""Write the port's serving goldens: the load simulator's summary of each
preset (steady, burst, overload) and the fleet simulator's summary of
each fleet preset (fleet_steady, fleet_overload, fleet_failover,
fleet_autoscale, fleet_faultstorm, fleet_cached), at seed 0, on
``reference_engine`` on the CPU, under the port's own defaults (the
Hopper byte models of telemetry/traffic.py, an H100's bandwidths in
``ServiceModel``, an H100's memory budget).

    python3 tools/write_serving_goldens.py           # rewrite tests/golden/torch_{serving,fleet}_*.json
    python3 tools/write_serving_goldens.py --check   # exit 1 if a file differs

``tests/test_torch_serving_golden.py`` and ``tests/test_torch_fleet.py``
hold the simulators to these files byte for byte. Rewrite them only with
a change that is meant to move the scheduler's or the router's decisions
or the byte models, and say why.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.serving import fleet  # noqa: E402
from repro_torch.serving import simulator as sim  # noqa: E402

GOLDEN_DIR = ROOT / "tests" / "golden"


def engine():
    return sim.reference_engine(device="cpu")


def golden_text(name: str) -> str:
    """The golden file's text for preset ``name`` (a fleet preset's name
    starts with ``fleet_``)."""
    if name.startswith("fleet_"):
        rep = fleet.simulate_fleet(fleet.fleet_preset(name, seed=0), engine)
    else:
        rep = sim.simulate(engine(), sim.preset(name, seed=0))
    return rep.to_json() + "\n"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check", action="store_true", help="compare with the files instead of writing them")
    args = parser.parse_args(argv)
    differ = 0
    for name in sim.PRESETS + fleet.FLEET_PRESETS:
        path = GOLDEN_DIR / (f"torch_{name}.json" if name.startswith("fleet_") else f"torch_serving_{name}.json")
        text = golden_text(name)
        if args.check:
            same = path.exists() and path.read_text() == text
            differ += not same
            print(f"{path.relative_to(ROOT)}: {'same' if same else 'differs'}")
        else:
            path.write_text(text)
            print(f"wrote {path.relative_to(ROOT)}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
