"""Phase K of chip_smoke.py three times at once, each followed by 8 more
card solves and 2 CPU solves of its captured keyframe step: how far the
accepted steps and the final window cost spread on one input.

    python3 scripts/k_step_spread.py            # on a machine with a GPU

Each run writes a JSON line (`card_steps`, `card_costs`, `cpu`) to stdout.
"""
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def one_run():
    import chip_smoke as cs
    from rd_vio_tpu_torch.models import builders

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    try:
        cs.phase_k(cs.DEV)
        out = {"phase_k": "passed"}
    except SystemExit as e:
        out = {"phase_k": str(e)}
    (a, prior, calib, it, prev, lip), (res_g, *_) = builders.CAPTURED_KEYFRAME
    card = [res_g] + [builders.run_keyframe_fused(a, prior, calib, it, prev=prev,
                                                  loc_ip_prev=lip)[0] for _ in range(8)]
    prior_c, calib_c, prev_c = cs.to_cpu((prior, calib, prev))
    cpu = [builders.run_keyframe_fused(a, prior_c, calib_c, it, prev=prev_c,
                                       loc_ip_prev=lip)[0] for _ in range(2)]
    out.update(initial_cost=float(res_g.initial_cost),
               card_steps=[int(r.iterations) for r in card],
               card_costs=[float(r.cost) for r in card],
               cpu=[[int(r.iterations), float(r.cost)] for r in cpu])
    print(json.dumps(out))


def main(argv):
    if "--one" in argv:
        one_run()
        return 0
    if not torch.cuda.is_available():
        print("k_step_spread: no CUDA device", file=sys.stderr)
        return 1
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--one"],
                              stdout=subprocess.PIPE, text=True) for _ in range(3)]
    rc = 0
    for p in procs:
        out, _ = p.communicate()
        print(out.strip().splitlines()[-1] if out.strip() else "{}")
        rc |= p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
