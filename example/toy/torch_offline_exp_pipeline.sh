#!/usr/bin/env bash
# Toy offline experiment pipeline through the PyTorch/CUDA port
# (ultra_pytorch_tpu_torch), the counterpart of offline_exp_pipeline.sh:
# clean -> feature stats -> normalize -> initial ranking (the port's
# linear ranker) -> ULTRA-format prep -> train -> test. Nothing imports
# JAX. DEVICE is cuda (default; every step raises without a card) or cpu.
set -euo pipefail
cd "$(dirname "$0")/../.."

RAW=tests/data            # toy libsvm twin lives next to the ULTRA fixtures
WORK=${WORK:-/tmp/ultra_toy_torch_pipeline}
DEVICE=${DEVICE:-cuda}
mkdir -p "$WORK"/{raw,rank,prep}

for split in train valid test; do
  python libsvm_tools/clean_libsvm_file.py \
    "$RAW/$split/$split.txt" "$WORK/raw/$split.txt" 1
done

python libsvm_tools/extract_feature_statistics.py "$WORK/raw/"
for split in train valid test; do
  python libsvm_tools/normalize_feature.py \
    "$WORK/raw/feature_scale.json" "$WORK/raw/$split.txt" \
    "$WORK/raw/$split.norm.txt"
  mv "$WORK/raw/$split.norm.txt" "$WORK/raw/$split.txt"
done

python -m ultra_pytorch_tpu_torch.pipeline.initial_ranking \
  "$WORK/raw/train.txt" "$WORK/raw/valid.txt" "$WORK/raw/test.txt" \
  "$WORK/rank/" 200 --device "$DEVICE"

FEATURE_SIZE=$(python -c "import json;print(len(json.load(open('$WORK/raw/feature_scale.json'))))")
python libsvm_tools/prepare_exp_data_with_rank.py \
  "$WORK/raw" "$WORK/rank/" "$WORK/prep/" "$FEATURE_SIZE"

python -m ultra_pytorch_tpu_torch.run --device "$DEVICE" \
  --data_dir="$WORK/prep/" \
  --model_dir="$WORK/model/" \
  --output_dir="$WORK/out/" \
  --setting_file=configs/dla.json \
  --batch_size=16 \
  --max_train_iteration="${MAX_ITER:-100}" \
  --steps_per_checkpoint=50

python -m ultra_pytorch_tpu_torch.run --device "$DEVICE" \
  --data_dir="$WORK/prep/" \
  --model_dir="$WORK/model/" \
  --output_dir="$WORK/out/" \
  --setting_file=configs/dla.json \
  --test_only
