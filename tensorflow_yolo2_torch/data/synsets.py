"""ImageNet synset ↔ ILSVRC-id mapping utilities (a copy of
tensorflow_yolo2_tpu/data/synsets.py, which imports no JAX).

Capability of reference src/img_dataset/ilsvrc2017_cls_multithread.py:418-447
(``save_synset_to_ilsvrcid_map`` / ``save_ilsvrcid_to_synset_map``) and its
shipped assets (syn2ilsid_map.pickle, ilsid2syn_map.pickle,
imagenet_lsvrc_2015_synsets.txt): build and persist the bidirectional map
between WordNet synset ids (n01440764) and contiguous ILSVRC class indices.

Two sources are supported: the devkit ``meta_clsloc`` text/mat listing
(id per line alongside the synset), or a plain ordered synset list file
(one synset per line — the index is the line number, the convention of
imagenet_lsvrc_2015_synsets.txt).
"""

from __future__ import annotations

import os
import pickle


def load_synset_list(path: str) -> list[str]:
    """Ordered synsets, one per line (imagenet_lsvrc_2015_synsets.txt)."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def build_maps_from_list(synsets: list[str]) -> tuple[dict, dict]:
    """1-based ILSVRC ids by list order (the devkit convention)."""
    syn2id = {s: i + 1 for i, s in enumerate(synsets)}
    id2syn = {i + 1: s for i, s in enumerate(synsets)}
    return syn2id, id2syn


def build_maps_from_meta(meta_file: str) -> tuple[dict, dict]:
    """Parse a devkit meta listing with ``<id> <synset> ...`` per line."""
    syn2id: dict[str, int] = {}
    with open(meta_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and parts[1].startswith("n"):
                syn2id[parts[1]] = int(parts[0])
    return syn2id, {v: k for k, v in syn2id.items()}


def save_maps(syn2id: dict, id2syn: dict, out_dir: str) -> tuple[str, str]:
    """Persist both pickles with the reference's asset names."""
    os.makedirs(out_dir, exist_ok=True)
    p1 = os.path.join(out_dir, "syn2ilsid_map.pickle")
    p2 = os.path.join(out_dir, "ilsid2syn_map.pickle")
    with open(p1, "wb") as f:
        pickle.dump(syn2id, f)
    with open(p2, "wb") as f:
        pickle.dump(id2syn, f)
    return p1, p2


def load_maps(dir_path: str) -> tuple[dict, dict]:
    with open(os.path.join(dir_path, "syn2ilsid_map.pickle"), "rb") as f:
        syn2id = pickle.load(f)
    with open(os.path.join(dir_path, "ilsid2syn_map.pickle"), "rb") as f:
        id2syn = pickle.load(f)
    return syn2id, id2syn
