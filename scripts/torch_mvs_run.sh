#!/usr/bin/env bash
# Thin wrapper mirroring the reference's mvs_run.sh for the PyTorch port
# (nerfactor_tpu_torch.data_gen.dtu_surf_from_mvs): resolves the repo
# root onto PYTHONPATH and forwards all flags.
set -e
REPO_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="$REPO_DIR:$PYTHONPATH"
exec python -m nerfactor_tpu_torch.data_gen.dtu_surf_from_mvs "$@"
