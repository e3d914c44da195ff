"""chip_smoke.py's slab phases alone, on the card: the slab smoother
kernels at every level of rt's hierarchies in 2 slabs ("slab"), rt
(64x64x128) and shear3d_vd (128x128x32) split over 2 ranks against 1
rank ("sharded_mg"), and the x-slab meshes whose x ends in walls, inflow
or outflow: the slab forms with the level's x walls on the end ranks at
every level of the channel's hierarchies, the channel (128x64x16) and
bingham (64x64x16) decks on 2 ranks ("sharded_xwalls"), and embedded
boundaries on the mesh: the slab forms at every level of channel_cyl's
and poiseuille_cyl_bingham's MAC and cut-cell velocity hierarchies,
channel_cyl (128x64x16) and poiseuille_cyl_bingham (64x64x16) on 2
ranks ("sharded_eb"), and 2D decks and the two Godunov options on the
mesh: tgv2d 128^2 by MOL and by Godunov, the 2D EB cylinder at 128^2,
rt2d 64x128 and shear3d 128x128x32 with use_mac_phi_in_godunov and with
both options, on 2 ranks ("sharded_2d"), and both AMR drivers on the
mesh: rt_amr (64x64x128 with its 128x128x32 patch) and three small
float64 AMR cells on 2 ranks ("sharded_amr"), and the last cells of
ROADMAP A13b and A14 on 2 ranks: channel_cyl with one refined level at
64x32x8, a shear3d level held whole, the rfftn deck's V-cycles on the
slabs ("sharded_amr_eb").  "amr_eb" runs the EB part of chip_smoke's
AMR phase on one card (its paths deck, the channel_cyl_amr cell, its
patch levels' smoothers, its CLI restart); it is not a slab phase and
runs only when named (ALONE).  Builds the kernel libraries first; the
sharded phases share one spawn of the ranks (chip_smoke.run_sharded).

    python scripts/slab_smoke.py                   # every slab phase
    python scripts/slab_smoke.py sharded_xwalls    # that phase alone
    python scripts/slab_smoke.py sharded_eb
    python scripts/slab_smoke.py sharded_2d
    python scripts/slab_smoke.py sharded_amr
    python scripts/slab_smoke.py sharded_amr_eb
    python scripts/slab_smoke.py amr_eb            # chip_smoke's 5b, EB
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PHASES = ("slab", "sharded_mg", "sharded_xwalls", "sharded_eb",
          "sharded_2d", "sharded_amr", "sharded_amr_eb", "amr_eb")
# the phases that run only when named
ALONE = ("amr_eb",)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("slab_smoke: needs a card", file=sys.stderr)
        return 2
    phases = argv or [p for p in PHASES if p not in ALONE]
    if any(p not in PHASES for p in phases):
        print(f"slab_smoke: phases are {', '.join(PHASES)}", file=sys.stderr)
        return 2
    import incflo_torch
    from incflo_torch.ops import cuda_build
    from incflo_torch.ops import godunov_kernels as gk
    from incflo_torch.ops import multigrid as mg
    from incflo_torch.ops import smoother_kernels as sk
    from incflo_torch.ops import step2d_kernels as s2
    t0 = time.time()
    cs.phase_build(cuda_build, [gk.SOURCE, sk.SOURCE, s2.SOURCE])
    sharded = {"sharded_mg": lambda: cs.phase_sharded_mg(incflo_torch, torch),
               "sharded_xwalls": lambda: cs.phase_sharded_xwalls(
                   incflo_torch, sk, mg, torch),
               "sharded_eb": lambda: cs.phase_sharded_eb(
                   incflo_torch, sk, mg, torch),
               "sharded_2d": lambda: cs.phase_sharded_2d(incflo_torch,
                                                         torch),
               "sharded_amr": lambda: cs.phase_sharded_amr(incflo_torch,
                                                           torch),
               "sharded_amr_eb": lambda: cs.phase_sharded_amr_eb(
                   incflo_torch, torch)}

    def stamp(what):
        print(f"[time] {what} done at {time.time() - t0:.1f} s", flush=True)
    out = {}
    if "amr_eb" in phases:
        out["amr_eb"] = cs.phase_amr(incflo_torch, gk, sk, s2, mg, torch,
                                     stamp, names=cs.AMR_EB)
    if "slab" in phases:
        out["slab"] = cs.phase_slab_smoothers(sk, mg, torch)
        stamp("slab")
    gens = {p: sharded[p]() for p in phases if p in sharded}
    if gens:
        out.update(cs.run_sharded(gens, stamp))
    print(json.dumps(out))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
