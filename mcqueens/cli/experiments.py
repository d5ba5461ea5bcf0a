"""Config-driven experiment CLI (reference ``python experiments.py`` equivalent).

Reads the reference YAML schema verbatim (including the ``betta_scheduling``
key and 'None'-string patience) plus the optional ``sampler:`` section, then
dispatches to the batched drivers.  Unlike the reference (which ignores argv,
``run_montecarlo.sh:22``), the config path and output root are flags:

    python -m mcqueens.cli.experiments [--config config.yaml] [--outdir .]
        [--mesh] [--profile-dir DIR]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="config.yaml")
    parser.add_argument("--outdir", default=".",
                        help="root for figures/ and results/ outputs")
    parser.add_argument("--mesh", action="store_true",
                        help="shard chains over all visible devices")
    parser.add_argument("--profile-dir", default=None,
                        help="write a jax.profiler trace here")
    args = parser.parse_args(argv)

    from mcqueens.dist import mesh as mesh_mod
    from mcqueens.experiments import drivers
    from mcqueens.experiments.config import load_config
    from mcqueens.utils import cache, profiling

    cache.enable()

    cfg = load_config(args.config)
    mesh = None
    if args.mesh or cfg.sampler.mesh:
        if isinstance(cfg.sampler.mesh, bool) or args.mesh:
            mesh = mesh_mod.make_mesh()
        else:  # int: shard over the first n devices (config.py docstring)
            import jax

            mesh = mesh_mod.make_mesh(jax.devices()[: int(cfg.sampler.mesh)])

    with profiling.trace(args.profile_dir or cfg.sampler.profile_dir):
        with profiling.timed(f"experiment {cfg.experiment_type}"):
            drivers.run_from_config(cfg, outdir=args.outdir, mesh=mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
