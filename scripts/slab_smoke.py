"""chip_smoke.py's slab phases alone, on the card: the slab smoother
kernels at every level of rt's hierarchies in 2 slabs ("slab"), then rt
(64x64x128) and shear3d_vd (128x128x32) split over 2 ranks against 1
rank ("sharded_mg").  Builds the kernel libraries first.

    python scripts/slab_smoke.py            # on a machine with a card
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        print("slab_smoke: needs a card", file=sys.stderr)
        return 2
    import incflo_torch
    from incflo_torch.ops import cuda_build
    from incflo_torch.ops import godunov_kernels as gk
    from incflo_torch.ops import multigrid as mg
    from incflo_torch.ops import smoother_kernels as sk
    from incflo_torch.ops import step2d_kernels as s2
    t0 = time.time()
    cs.phase_build(cuda_build, [gk.SOURCE, sk.SOURCE, s2.SOURCE])
    slab = cs.phase_slab_smoothers(sk, mg, torch)
    print(f"[time] slab done at {time.time() - t0:.1f} s", flush=True)
    shard_mg = cs.phase_sharded_mg(incflo_torch, torch)
    print(f"[time] sharded_mg done at {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"slab": slab, "sharded_mg": shard_mg}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
