"""Check, or regenerate, the bundled ``sim/assets/g1_29dof.json`` from a URDF.

    python -m bridgerl_tpu_torch.cli.extract_urdf_spec --urdf path/to/main.urdf          # check
    python -m bridgerl_tpu_torch.cli.extract_urdf_spec --urdf path/to/main.urdf --write  # regenerate

The flags of ``scripts/extract_urdf_spec.py``. The reference loads the
vendor URDF through Isaac Sim (play_g1_npy.py:50-63); the port bundles the
chain extracted from it (the links on actuated paths, joint origins, axes
and limits in the canonical 29-joint order) and the collision primitives of
those links. Exit 0: the spec equals a fresh extraction; 1: it differs (the
differences are printed). It parses XML on the host and takes no
``--device``.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from ..sim.urdf import (
    G1_JOINT_NAMES,
    G1_SPEC_PATH,
    KinematicChain,
    build_chain,
    chains_equal,
    collisions_equal,
    collisions_from_rows,
    collisions_to_rows,
    parse_urdf_collisions,
    parse_urdf_joints,
)


def extract(urdf_path: str) -> KinematicChain:
    return build_chain(parse_urdf_joints(urdf_path), G1_JOINT_NAMES)


def extract_collisions(urdf_path: str, chain: KinematicChain):
    """The collision primitives of the links the chain keeps."""
    keep = set(chain.link_names)
    return [p for p in parse_urdf_collisions(urdf_path) if p.link in keep]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--urdf", required=True, help="Path to the vendor main.urdf")
    p.add_argument("--spec", default=G1_SPEC_PATH,
                   help="Bundled spec JSON to verify/regenerate")
    p.add_argument("--write", action="store_true",
                   help="Overwrite the spec with the fresh extraction")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    chain = extract(args.urdf)
    prims = extract_collisions(args.urdf, chain)
    print(f"extracted: {chain.num_links} links, {chain.num_actuated} actuated "
          f"joints, {len(prims)} collision primitives from {args.urdf}")
    if args.write:
        d = json.loads(chain.to_json())
        d["collisions"] = collisions_to_rows(prims)
        with open(args.spec, "w") as f:
            json.dump(d, f)
        print(f"wrote {args.spec}")
        return 0

    with open(args.spec) as f:
        raw = f.read()
    diffs = chains_equal(KinematicChain.from_json(raw), chain)
    diffs += collisions_equal(collisions_from_rows(json.loads(raw).get("collisions", [])), prims)
    if diffs:
        print("SPEC MISMATCH:")
        for d in diffs:
            print(f"  - {d}")
        return 1
    print(f"OK: {args.spec} matches the extraction from {args.urdf}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
