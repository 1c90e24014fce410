#!/usr/bin/env bash
# The generic LETOR dataset pipeline through the PyTorch/CUDA port
# (ultra_pytorch_tpu_torch): clean -> normalize -> sample -> initial
# ranking -> ULTRA prep -> train -> test. The same steps and variables as
# example/dataset_pipeline.sh; the initial ranker, the re-prediction of the
# full train file, training and testing run through the port, and nothing
# imports JAX.
#
#   DATA_PATH   directory containing {train,valid|vali,test}.txt (libsvm)
#   WORK        scratch/output directory
#   FEATURES    feature count (e.g. 136 for MSLR, 700 for Yahoo set1)
#   NORM_MODE   "" for linear [-1,1] rescale, "log" for log10 (Istella)
#   PREFIX      filename prefix (e.g. "set1." for Yahoo)
#   SETTING     experiment JSON (default configs/dla.json)
#   MAX_ITER    training steps (default 10000)
#   BATCH       training batch size (default 256)
#   DEVICE      cuda (default; every step raises without a card) or cpu
#
# Any example/<dataset>/offline_exp_pipeline.sh wrapper's variables work
# here too, e.g. for MSLR-WEB10K:
#   DATA_PATH=./MSLR_10k_letor/Fold1 WORK=./MSLR_10k_letor/work \
#   FEATURES=136 NORM_MODE="" bash example/torch_dataset_pipeline.sh
set -euo pipefail
cd "$(dirname "$0")/.."

DATA_PATH=${DATA_PATH:?set DATA_PATH to the raw libsvm directory}
WORK=${WORK:?set WORK to a scratch directory}
FEATURES=${FEATURES:?set FEATURES}
NORM_MODE=${NORM_MODE:-}
PREFIX=${PREFIX:-}
SETTING=${SETTING:-configs/dla.json}
MAX_ITER=${MAX_ITER:-10000}
BATCH=${BATCH:-256}
DEVICE=${DEVICE:-cuda}

mkdir -p "$WORK"/{cleaned,normalized,rank,prep}

# Accept vali.txt or valid.txt; split train 10% when neither exists.
VALID_SRC="$DATA_PATH/${PREFIX}vali.txt"
[ -f "$VALID_SRC" ] || VALID_SRC="$DATA_PATH/${PREFIX}valid.txt"
if [ ! -f "$VALID_SRC" ]; then
  echo "no valid split; carving 10% of train"
  python libsvm_tools/split_libsvm_data.py \
    "$DATA_PATH/${PREFIX}train.txt" "$WORK/cleaned/valid_raw.txt" \
    "$WORK/cleaned/train_raw.txt" 0.1 13
  TRAIN_SRC="$WORK/cleaned/train_raw.txt"
  VALID_SRC="$WORK/cleaned/valid_raw.txt"
else
  TRAIN_SRC="$DATA_PATH/${PREFIX}train.txt"
fi

echo "cleaning"
python libsvm_tools/clean_libsvm_file.py "$TRAIN_SRC" "$WORK/cleaned/train.txt" 0
python libsvm_tools/clean_libsvm_file.py "$VALID_SRC" "$WORK/cleaned/valid.txt" 1
python libsvm_tools/clean_libsvm_file.py "$DATA_PATH/${PREFIX}test.txt" "$WORK/cleaned/test.txt" 1

echo "normalizing ($NORM_MODE)"
python libsvm_tools/extract_feature_statistics.py "$WORK/cleaned/"
for split in train valid test; do
  python libsvm_tools/normalize_feature.py \
    "$WORK/cleaned/feature_scale.json" "$WORK/cleaned/$split.txt" \
    "$WORK/normalized/$split.txt" $NORM_MODE
done

echo "initial ranking (1% sample, linear ranker on $DEVICE)"
python libsvm_tools/sample_libsvm_data.py \
  "$WORK/normalized/train.txt" "$WORK/normalized/sampled_train.txt" 0.01 13
python -m ultra_pytorch_tpu_torch.pipeline.initial_ranking \
  "$WORK/normalized/sampled_train.txt" "$WORK/normalized/valid.txt" \
  "$WORK/normalized/test.txt" "$WORK/rank/" 500 --device "$DEVICE"
# overwrite train predictions with the full train file
python -m ultra_pytorch_tpu_torch.pipeline.initial_ranking \
  --predict "$WORK/rank/model.npz" "$WORK/normalized/train.txt" \
  "$WORK/rank/train.predict" --device "$DEVICE"

echo "preparing ULTRA format"
python libsvm_tools/prepare_exp_data_with_rank.py \
  "$WORK/normalized" "$WORK/rank/" "$WORK/prep/" "$FEATURES"

echo "training on $DEVICE"
python -m ultra_pytorch_tpu_torch.run --device "$DEVICE" \
  --data_dir="$WORK/prep/" --model_dir="$WORK/model/" \
  --output_dir="$WORK/out/" --setting_file="$SETTING" \
  --batch_size="$BATCH" --max_train_iteration="$MAX_ITER"

python -m ultra_pytorch_tpu_torch.run --device "$DEVICE" \
  --data_dir="$WORK/prep/" --model_dir="$WORK/model/" \
  --output_dir="$WORK/out/" --setting_file="$SETTING" --test_only
