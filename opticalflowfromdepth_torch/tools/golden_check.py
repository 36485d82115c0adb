"""Golden-number check of the released GMFlow checkpoints (port of
``opticalflowfromdepth_tpu/tools/golden_check.py``).

The reference's expected EPEs are comments in
`adjusted_gmflow/scripts/evaluate.sh:8-36`, run by hand and never
asserted. This harness asserts them: given the datasets and a checkpoint
(a reference-named ``.pth`` state_dict, or an ``.npz`` of the JAX
package's flax parameters, ``params/...`` keys), it runs the port's
validators (``eval/validators.py``) in f32 and compares each metric with
its golden value.

    python -m opticalflowfromdepth_torch.tools.golden_check \\
        --model gmflow --ckpt gmflow_chairs_things.pth \\
        --data_root datasets --datasets things_clean,sintel_clean \\
        --tol 0.03

Exit code 0 iff every requested metric is within ``--tol``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Tuple

# golden values: metric -> EPE, from `adjusted_gmflow/scripts/evaluate.sh:8-36`
GOLDEN: Dict[str, Dict[str, float]] = {
    "gmflow": {            # C+T checkpoint, no refinement (lines 8-14)
        "things_clean": 3.475,
        "sintel_clean": 1.495,
        "sintel_final": 2.955,
    },
    "gmflow_refine": {     # C+T checkpoint with refinement (lines 29-36)
        "things_clean": 2.804,
        "sintel_clean": 1.084,
        "sintel_final": 2.475,
    },
}

# per-model forward recipes (`scripts/evaluate.sh`: --num_scales etc.)
RECIPES = {
    "gmflow": dict(num_scales=1, upsample_factor=8,
                   attn_splits_list=(2,), corr_radius_list=(-1,),
                   prop_radius_list=(-1,), padding_factor=16),
    "gmflow_refine": dict(num_scales=2, upsample_factor=4,
                          attn_splits_list=(2, 8),
                          corr_radius_list=(-1, 4),
                          prop_radius_list=(-1, 1), padding_factor=32),
}


def load_params(ckpt: str, num_scales: int):
    """The port's GMFlow ``state_dict`` from a reference-named ``.pth``
    or from an ``.npz`` of flax parameters (``params/<module>/...``)."""
    if ckpt.endswith(".npz"):
        import numpy as np

        from ..weights import gmflow_state_dict_from_flax
        tree: dict = {}
        with np.load(ckpt) as flat:
            for key in flat.files:
                parts = key.split("/")
                if parts[0] != "params" or len(parts) < 3:
                    raise ValueError(f"{ckpt}: {key!r} is not a "
                                     "params/<module>/<leaf> key")
                node = tree
                for p in parts[1:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = flat[key]
        return gmflow_state_dict_from_flax(tree, num_scales)
    from ..eval.cli import load_state_dict
    return load_state_dict(ckpt)


def make_infer_fn(model_name: str, state_dict, device="cuda"
                  ) -> Tuple[Callable, int]:
    """The f32 forward of ``model_name``'s recipe with these weights, and
    the padding factor its validators use."""
    from ..eval.infer import gmflow_infer_fn
    from ..models.gmflow import GMFlow

    r = RECIPES[model_name]
    model = GMFlow(num_scales=r["num_scales"],
                   upsample_factor=r["upsample_factor"])
    model.load_state_dict(state_dict, strict=True)
    return gmflow_infer_fn(model, r["attn_splits_list"],
                           r["corr_radius_list"], r["prop_radius_list"],
                           device=device), r["padding_factor"]


def run_check(model_name: str, infer_fn: Callable, padding_factor: int,
              data_root: str, dataset_keys, tol: float,
              golden=None) -> Dict[str, Dict[str, float]]:
    """Run each requested validator and compare with its golden value.
    Free of I/O policy, so tests can swap ``VALIDATORS`` for fakes."""
    golden = golden if golden is not None else GOLDEN[model_name]
    results = {}
    for key in dataset_keys:
        expected = golden[key]
        measured = VALIDATORS[key](infer_fn, data_root, padding_factor)
        results[key] = {
            "expected": expected,
            "measured": round(measured, 4),
            "abs_err": round(abs(measured - expected), 4),
            "ok": abs(measured - expected) <= tol,
        }
    return results


def _v_things(infer_fn, root, pf):
    from ..eval.validators import validate_things
    return validate_things(infer_fn, root=root, dstype="frames_cleanpass",
                           padding_factor=pf)["things_clean_epe"]


def _v_sintel(dstype):
    def v(infer_fn, root, pf):
        from ..eval.validators import validate_sintel
        return validate_sintel(infer_fn, root=root, dstype=dstype,
                               padding_factor=pf)[f"sintel_{dstype}_epe"]
    return v


VALIDATORS = {
    "things_clean": _v_things,
    "sintel_clean": _v_sintel("clean"),
    "sintel_final": _v_sintel("final"),
}


def main(argv=None) -> Dict[str, Dict[str, float]]:
    """Runs the check and prints the results as JSON; returns them when
    every metric is within ``--tol``, else exits with code 1."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=sorted(GOLDEN), required=True)
    ap.add_argument("--ckpt", required=True,
                    help="reference-named .pth, or .npz of flax params")
    ap.add_argument("--data_root", default="datasets")
    ap.add_argument("--datasets", default=None,
                    help="comma list (default: all golden metrics)")
    ap.add_argument("--tol", type=float, default=0.03,
                    help="absolute EPE tolerance (f32 evaluation numerics "
                    "and resize differences)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    keys = (args.datasets.split(",") if args.datasets
            else sorted(GOLDEN[args.model]))
    state_dict = load_params(args.ckpt, RECIPES[args.model]["num_scales"])
    infer_fn, pf = make_infer_fn(args.model, state_dict, args.device)
    results = run_check(args.model, infer_fn, pf, args.data_root, keys,
                        args.tol)
    print(json.dumps({"model": args.model, "results": results}, indent=2))
    if not all(r["ok"] for r in results.values()):
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
