"""Resting-pose distribution parity across settle configurations
(``tools/settle_fidelity.py`` on the port).

The reference schedule is 100 frames x 4 substeps with contacts every
substep and a 256-pair narrowphase budget. A configuration that changes
the cadence, the pair budget or ends the settle early must keep the
resting poses' distribution: the resting heights' median, 90% quantile
and maximum, and the pairwise XY distances' median and 90% quantile over
all seeds x objects, within the JAX script's thresholds of the reference's
(``dz_med < 0.01``, ``dz_q90 < 0.02``, ``dz_max < 0.05``, ``dpd_med <
0.10``, ``dpd_q90 < 0.20``, metres).

    python -m stillleben_tpu_torch.tools.settle_fidelity [--seeds 24] \
        [--device cuda] [--dense MESH] [config ...]

Configs (default: all): ref, tuned, frame_p128, sleep10, sleep10_frame,
sleep10_every2. The scenes are the bench's "textured" composition
(``templates.py``; the dense mesh is the procedural blob unless ``--dense``
names a file), drawn from one ``torch.Generator`` seeded 7 for every
config, so every config settles the same draws; the JAX script draws with
``jax.random.split(PRNGKey(7))``, so the two compare as distributions. A
non-finite pose is an error; a FAIL line is a result.
"""

from __future__ import annotations

import argparse

import numpy as np

FRAMES = 100
THRESHOLDS = {"dz_med": 0.01, "dz_q90": 0.02, "dz_max": 0.05, "dpd_med": 0.10, "dpd_q90": 0.20}


def configs():
    """The JAX script's ``SolverConfig`` variants (tools/settle_fidelity.py:46-60)."""
    from ..physics.types import default_config

    base = default_config()
    return {
        "ref": base._replace(contact_gen="substep", max_narrow_pairs=256),
        "tuned": base._replace(contact_gen="every2", max_narrow_pairs=128),
        "frame_p128": base._replace(contact_gen="frame", max_narrow_pairs=128),
        "sleep10": base._replace(contact_gen="substep", max_narrow_pairs=256, sleep_frames=10),
        "sleep10_frame": base._replace(contact_gen="frame", max_narrow_pairs=128,
                                       sleep_frames=10),
        "sleep10_every2": base._replace(contact_gen="every2", max_narrow_pairs=128,
                                        sleep_frames=10),
    }


def stats(poses) -> tuple[np.ndarray, np.ndarray]:
    """(resting z (S, N), pairwise XY distances of each scene's objects,
    flattened) of (S, N, 4, 4) poses; raises on a non-finite pose."""
    p = np.asarray(poses)
    if not np.isfinite(p).all():
        raise FloatingPointError("non-finite settle")
    z = p[:, :, 2, 3]
    xy = p[:, :, :2, 3]
    d = np.linalg.norm(xy[:, :, None, :] - xy[:, None, :, :], axis=-1)
    iu = np.triu_indices(p.shape[1], 1)
    return z, d[:, iu[0], iu[1]].ravel()


def ref_line(z_ref: np.ndarray, pd_ref: np.ndarray) -> str:
    return (f"ref: z_med {np.median(z_ref):.4f} z_q90 {np.quantile(z_ref, .9):.4f} "
            f"zmax {z_ref.max():.4f} pd_med {np.median(pd_ref):.4f} "
            f"pd_q90 {np.quantile(pd_ref, .9):.4f}")


def deltas(z, pd, z_ref, pd_ref) -> dict:
    return {"dz_med": abs(np.median(z) - np.median(z_ref)),
            "dz_q90": abs(np.quantile(z, 0.9) - np.quantile(z_ref, 0.9)),
            "dz_max": abs(z.max() - z_ref.max()),
            "dpd_med": abs(np.median(pd) - np.median(pd_ref)),
            "dpd_q90": abs(np.quantile(pd, 0.9) - np.quantile(pd_ref, 0.9))}


def verdict(d: dict) -> bool:
    return all(d[k] < t for k, t in THRESHOLDS.items())


def config_line(name: str, z, pd, z_ref, pd_ref) -> str:
    d = deltas(z, pd, z_ref, pd_ref)
    return (f"{name:16s} dz_med {d['dz_med']:.4f} dz_q90 {d['dz_q90']:.4f} "
            f"dz_max {d['dz_max']:.4f} dpd_med {d['dpd_med']:.4f} dpd_q90 {d['dpd_q90']:.4f} "
            f"zmax {z.max():.3f}  {'PASS' if verdict(d) else 'FAIL'}")


def settle_poses(tpl, cfg, seeds: int, frames: int = FRAMES, quats=None) -> np.ndarray:
    """(seeds, N, 4, 4) resting poses of the template's scene under
    ``cfg``: ``seeds`` scenes drawn from a generator seeded 7 (or the given
    (seeds, N, 4) orientations), settled as one batch."""
    import torch

    from ..parallel.batch import settle_scene

    generator = torch.Generator().manual_seed(7)
    poses, _, _ = settle_scene(generator, seeds, tpl, cfg, frames, quats=quats)
    return poses.cpu().numpy()


def run(names, seeds: int = 24, device: str = "cuda", dense: str | None = None,
        out=print) -> dict:
    """Print the script's lines; returns {config: (z, pd)} (``ref`` first)."""
    from .templates import build_template

    tpl, dense_name = build_template(device, dense)
    out(f"dense mesh: {dense_name}; {seeds} seeds x {FRAMES} frames on {device}")
    table = configs()
    results = {"ref": stats(settle_poses(tpl, table["ref"], seeds, FRAMES))}
    out(ref_line(*results["ref"]))
    for name in names or list(table):
        if name == "ref":
            continue
        results[name] = stats(settle_poses(tpl, table[name], seeds, FRAMES))
        out(config_line(name, *results[name], *results["ref"]))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dense", default=None, help="the dense mesh's file (default: the blob)")
    ap.add_argument("configs", nargs="*")
    args = ap.parse_args(argv)
    unknown = set(args.configs) - set(configs())
    if unknown:
        ap.error(f"unknown configs {sorted(unknown)} (known: {list(configs())})")
    return run(args.configs, args.seeds, args.device, args.dense,
               out=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
