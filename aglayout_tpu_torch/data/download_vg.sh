#!/usr/bin/env bash
# Visual Genome download + unzip (reference data/Datasets/vg/download_vg.sh
# equivalent). Fetches the VG v1.4 JSON metadata and both image parts into
# $VG_DIR (default data/vg). Requires network access.
set -euo pipefail
VG_DIR="${1:-data/vg}"
mkdir -p "$VG_DIR/images"
cd "$VG_DIR"

BASE="https://cs.stanford.edu/people/rak248/VG_100K_2"
VISUALGENOME="https://homes.cs.washington.edu/~ranjay/visualgenome/data/dataset"

for f in objects.json.zip attributes.json.zip relationships.json.zip \
         object_alias.txt relationship_alias.txt image_data.json.zip \
         region_descriptions.json.zip; do
  echo "fetching $f"
  wget -c "$VISUALGENOME/$f"
done
wget -c "$BASE/images.zip"
wget -c "$BASE/images2.zip"

for z in *.zip; do unzip -o "$z"; done
mv VG_100K/* images/ 2>/dev/null || true
mv VG_100K_2/* images/ 2>/dev/null || true
echo "done. Next: python -m aglayout_tpu_torch.data.split_vg && python -m aglayout_tpu_torch.data.preprocess_vg"
