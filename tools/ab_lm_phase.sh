#!/usr/bin/env bash
# The LM training phase of chip_smoke.py (full llama3.2-1b, 2 gloo ranks
# sharing cuda:0) in two trees on one card, in the order parent, change,
# change, parent, so that the card's drift falls on both sides alike.
#
#   bash tools/ab_lm_phase.sh PARENT_DIR [CHANGE_DIR]
#
# PARENT_DIR is a checkout of the commit to compare against (for example
# `git archive HEAD~1 | tar -x -C _dev/parent`); CHANGE_DIR defaults to
# the current directory. Both trees' kernels are built first, side by
# side; each run prints its "LM train run" line (tokens/s and phase_ms:
# forward+backward, exchange, update, a rank), tagged with its tree.
set -u
parent=${1:?usage: ab_lm_phase.sh PARENT_DIR [CHANGE_DIR]}
change=${2:-.}
build='import sys; sys.path[:0] = ["src"]; from repro_torch import kernels as K; K.build_all()'
run() {  # tree label
  (cd "$1" && python3 -c "
import sys; sys.path[:0] = ['src', 'tests']
import chip_smoke as cs
from repro_torch import kernels as K
K.build_all()
cs.lm_train_phase()
" 2>&1 | grep -E "LM train run|FAILED|Error" | sed "s/^/[$2] /" | cut -c1-700)
}
(cd "$parent" && python3 -c "$build") &
(cd "$change" && python3 -c "$build") &
wait
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run "$parent" parent1; run "$change" change1; run "$change" change2
run "$parent" parent2
