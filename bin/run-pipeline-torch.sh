#!/usr/bin/env bash
# Pipeline launcher of the PyTorch/CUDA port: `bin/run-pipeline-torch.sh
# <PipelineClass> <args...>` maps the same pipeline names as
# bin/run-pipeline.sh onto keystone_tpu_torch.pipelines.* and passes every
# argument through, --device included (the port runs on the card unless
# given --device cpu).
set -euo pipefail

if [[ $# -lt 1 ]]; then
  echo "usage: $0 <Pipeline> [args...]" >&2
  echo "pipelines: MnistRandomFFT LinearPixels RandomPatchCifar" >&2
  echo "           NewsgroupsPipeline AmazonReviewsPipeline TimitPipeline" >&2
  echo "           VOCSIFTFisher ImageNetSiftLcsFV" >&2
  exit 64
fi

PIPELINE="$1"; shift

case "$PIPELINE" in
  MnistRandomFFT)        MOD=keystone_tpu_torch.pipelines.images.mnist_random_fft ;;
  LinearPixels)          MOD=keystone_tpu_torch.pipelines.images.linear_pixels ;;
  RandomPatchCifar)      MOD=keystone_tpu_torch.pipelines.images.random_patch_cifar ;;
  NewsgroupsPipeline)    MOD=keystone_tpu_torch.pipelines.text.newsgroups ;;
  AmazonReviewsPipeline) MOD=keystone_tpu_torch.pipelines.text.amazon_reviews ;;
  TimitPipeline)         MOD=keystone_tpu_torch.pipelines.speech.timit ;;
  VOCSIFTFisher)         MOD=keystone_tpu_torch.pipelines.images.voc_sift_fisher ;;
  ImageNetSiftLcsFV)     MOD=keystone_tpu_torch.pipelines.images.imagenet_sift_lcs_fv ;;
  *) echo "unknown pipeline: $PIPELINE" >&2; exit 64 ;;
esac

REPO_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="${REPO_DIR}${PYTHONPATH:+:$PYTHONPATH}"

exec python -m "$MOD" "$@"
