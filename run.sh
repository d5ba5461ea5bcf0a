#!/usr/bin/env bash
# Launcher for config-driven sweeps over every card of one host.  The
# reference ships a SLURM/torchrun wrapper whose NCCL and torchrun lines
# target code that doesn't exist (run_montecarlo.sh, SURVEY §2 row 17); this
# is the working equivalent.
#
#   ./run.sh [--config config.yaml] [--outdir out]
#
# One process drives all the cards of the host: the chains axis is sharded
# over a 1-D mesh of every visible device (--mesh), so start exactly one
# copy per host.  The compile cache goes where JAX_COMPILATION_CACHE_DIR
# says, else to .jax_cache/ in this checkout (mcqueens/utils/cache.py).
set -euo pipefail
cd "$(dirname "$0")"

exec python -m mcqueens.cli.experiments --mesh "$@"
