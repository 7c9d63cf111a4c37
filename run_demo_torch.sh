#!/usr/bin/env bash
# End-to-end demo of the PyTorch/CUDA port (uc2_torch) on synthetic data, the
# counterpart of run_demo.sh without its benchmark step: build a corpus,
# pretrain a few steps, finetune retrieval, VQA and NLVR2 from the pretrained
# checkpoint. Prints each step's wall time. Arguments are passed to every
# driver (e.g. --device cpu with a narrow config/uc2-base.json).
set -euo pipefail
cd "$(dirname "$0")"

step() {
    local name=$1 t0
    shift
    t0=$(date +%s.%N)
    "$@"
    echo "[run_demo_torch] $name: $(awk "BEGIN {print $(date +%s.%N) - $t0}") s"
}

step make_demo_data python -m uc2_torch.make_demo_data
step pretrain python -m uc2_torch.pretrain --config config/demo_pretrain.json "$@"
CKPT=output/demo_pretrain/ckpt/$(ls output/demo_pretrain/ckpt | grep model_step | sort -V | tail -1)
step itm python -m uc2_torch.itm "$@" \
    --checkpoint "$CKPT" \
    --train_txt_db data/demo/en/txt_db --train_img_db data/demo/en/img_db \
    --val_txt_db data/demo/en/txt_db --val_img_db data/demo/en/img_db \
    --output_dir output/demo_itm \
    --num_train_steps 20 --warmup_steps 5 --valid_steps 20 \
    --eval_txt_limit 16 --log_steps 5
# the remaining finetune families (VE = VQA with 3 answers, uc2_torch.ve)
step vqa python -m uc2_torch.vqa "$@" \
    --checkpoint "$CKPT" \
    --train_txt_db data/demo/en/txt_db --train_img_db data/demo/en/img_db \
    --val_txt_db data/demo/en/txt_db --val_img_db data/demo/en/img_db \
    --num_answer 16 --output_dir output/demo_vqa \
    --train_batch_size 16 --num_train_steps 10 --warmup_steps 2 \
    --valid_steps 10 --val_batches 2 --save_steps 10 --log_steps 5
# run_demo.sh's NLVR2 step runs under the driver's default uniter-base
# config, whose 30522 words and 512 positions cannot take the uc2-base
# checkpoint (both packages raise a shape mismatch); this one names uc2-base
step nlvr2 python -m uc2_torch.nlvr2 "$@" \
    --model_config config/uc2-base.json \
    --checkpoint "$CKPT" \
    --train_txt_db data/demo/en/txt_db --train_img_db data/demo/en/img_db \
    --fmt triplet --pred_csv output/demo_nlvr2/preds.csv \
    --output_dir output/demo_nlvr2 \
    --train_batch_size 8 --num_train_steps 10 --warmup_steps 2 \
    --valid_steps 10 --save_steps 10 --log_steps 5
