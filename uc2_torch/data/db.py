"""Text and image-feature databases over the U2S store (a copy of
uc2_tpu/data/db.py): ``DetectFeatDb``, ``SoftLabelDb``, ``TxtTokDb``,
``RoutingImageDb``, ``ImageDbGroup``, ``compute_num_bb`` and
``get_ids_and_lens``.

* Each database is one mmap'd U2S file (``txt.u2s``, ``feat.u2s``,
  ``soft_labels.u2s``) with sidecar JSONs.
* Host sharding is explicit: ``shard=(rank, world)`` keeps
  ``ids[rank::world]``.
* ``__getitem__`` returns numpy; the loaders make tensors once a batch.
* ``native=True`` (the default) reads through the native library and
  raises when it cannot be built; ``native=False`` reads in pure Python.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from uc2_torch.data.store import StoreReader


def compute_num_bb(confs: np.ndarray, conf_th: float, min_bb: int,
                   max_bb: int) -> int:
    """reference data/data.py:31-34."""
    return int(min(max_bb, max(min_bb, int((confs > conf_th).sum()))))


class DetectFeatDb:
    """Region-feature DB keyed by image filename.

    Values: features [nbb, 2048] (fp16 on disk), norm_bb [nbb, 6], conf,
    soft_labels [nbb, 1601]. ``nbb.json`` caches per-image region counts for
    the (conf_th, min, max) setting; recomputed from conf otherwise
    (reference data/data.py:80-95).
    """

    def __init__(self, img_dir: str, conf_th: float = 0.2, max_bb: int = 100,
                 min_bb: int = 10, num_bb: int = 36, native: bool = True,
                 keep_fp16: bool = True):
        self.img_dir = img_dir
        self.conf_th = conf_th
        self.max_bb = max_bb
        self.min_bb = min_bb
        # features stored fp16 stay fp16 through collate and H2D — half the
        # host memcpy and transfer bytes of the input pipeline's dominant
        # field; the model upcasts on device (ImageEmbeddings astype). The
        # reference instead upcasts at load (data/data.py:24-27) and ships
        # fp32 to the GPU.
        self.keep_fp16 = keep_fp16
        self._cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self.db = StoreReader(os.path.join(img_dir, "feat.u2s"), native=native)
        if conf_th == -1:
            from collections import defaultdict
            self.name2nbb = defaultdict(lambda: num_bb)
        else:
            nbb_path = os.path.join(
                img_dir, f"nbb_th{conf_th}_max{max_bb}_min{min_bb}.json")
            if os.path.exists(nbb_path):
                with open(nbb_path) as f:
                    self.name2nbb = json.load(f)
            else:
                self.name2nbb = self._compute_nbb()
                try:
                    with open(nbb_path, "w") as f:
                        json.dump(self.name2nbb, f)
                except OSError:
                    pass

    def _keys(self) -> List[str]:
        keys = self.db.get("__keys__")
        if keys is None:
            raise KeyError("feat.u2s missing __keys__ record")
        return keys

    def _compute_nbb(self) -> Dict[str, int]:
        out = {}
        for fname in self._keys():
            rec = self.db[fname]
            out[fname] = compute_num_bb(np.asarray(rec["conf"]), self.conf_th,
                                        self.min_bb, self.max_bb)
        return out

    def __contains__(self, fname: str) -> bool:
        return self.db.get_raw(fname) is not None

    def get_dump(self, fname: str) -> Dict[str, np.ndarray]:
        """Full record truncated to nbb, fp32 (reference get_dump,
        data/data.py:98-110)."""
        rec = self.db[fname]
        nbb = self.name2nbb[fname]
        return {k: np.asarray(v)[:nbb].astype(np.float32)
                if np.asarray(v).dtype == np.float16 else np.asarray(v)[:nbb]
                for k, v in rec.items()}

    def _decode(self, rec, fname: str) -> Tuple[np.ndarray, np.ndarray]:
        nbb = self.name2nbb[fname]
        feat = np.asarray(rec["features"])[:nbb]
        if not (self.keep_fp16 and feat.dtype == np.float16):
            feat = feat.astype(np.float32)
        bb = np.asarray(rec["norm_bb"])[:nbb].astype(np.float32)
        bb7 = np.concatenate([bb, bb[:, 4:5] * bb[:, 5:6]], axis=-1)
        return feat, bb7

    def prefetch(self, fnames: Sequence[str], cache_cap: int = 4096):
        """Batch-fetch + decode a set of images through the native store's
        thread pool (csrc/u2s.cpp u2s_batch_get) into a bounded cache —
        the input pipeline's analog of the reference's DataLoader worker
        processes (pretrain.py:90, n_workers=4)."""
        todo = [f for f in dict.fromkeys(fnames) if f not in self._cache]
        if not todo:
            return
        recs = self.db.batch_get(todo)
        for f, rec in zip(todo, recs):
            if rec is not None:
                self._cache[f] = self._decode(rec, f)
        while len(self._cache) > cache_cap:
            self._cache.pop(next(iter(self._cache)))

    def __getitem__(self, fname: str) -> Tuple[np.ndarray, np.ndarray]:
        """(features [nbb, D] fp32, bb7 [nbb, 7]) — bb7 appends w*h to the
        6-d normalized bbox (reference data/data.py:338-340)."""
        hit = self._cache.get(fname)
        if hit is not None:
            return hit
        return self._decode(self.db[fname], fname)


class SoftLabelDb:
    """Precomputed image-token soft labels (valid-token space) per image
    (reference Img_SoftLabel_Lmdb, data/data.py:185-190)."""

    def __init__(self, db_dir: str, native: bool = True):
        self.db = StoreReader(os.path.join(db_dir, "soft_labels.u2s"),
                              native=native)

    def __getitem__(self, fname: str) -> np.ndarray:
        return np.asarray(self.db[fname]).astype(np.float32)


class TxtTokDb:
    """Tokenized-text DB with sidecar jsons: id2len, meta (CLS/SEP/MASK ids +
    v_range), txt2img, img2txts (reference TxtTokLmdb, data/data.py:193-230).
    """

    def __init__(self, db_dir: str, max_txt_len: int = 60,
                 shard: Optional[Tuple[int, int]] = None,
                 native: bool = True):
        self.db_dir = db_dir
        with open(os.path.join(db_dir, "id2len.json")) as f:
            self.id2len = json.load(f)
        if max_txt_len == -1:
            ids = list(self.id2len.keys())
        else:
            ids = [i for i, l in self.id2len.items() if l <= max_txt_len]
        if shard is not None:
            rank, world = shard
            ids = ids[rank::world]
        self.ids = ids
        self.db = StoreReader(os.path.join(db_dir, "txt.u2s"), native=native)
        with open(os.path.join(db_dir, "meta.json")) as f:
            meta = json.load(f)
        self.cls_ = meta["CLS"]
        self.sep = meta["SEP"]
        self.mask = meta["MASK"]
        self.v_range = tuple(meta["v_range"])

    def __getitem__(self, id_: str) -> Dict:
        return self.db[id_]

    def combine_inputs(self, *inputs: Sequence[int]) -> np.ndarray:
        """[CLS] ids [SEP] (ids [SEP])* (reference data/data.py:216-220)."""
        out = [self.cls_]
        for ids in inputs:
            out.extend(list(ids) + [self.sep])
        return np.asarray(out, np.int64)

    @property
    def txt2img(self) -> Dict[str, str]:
        with open(os.path.join(self.db_dir, "txt2img.json")) as f:
            return json.load(f)

    @property
    def img2txts(self) -> Dict[str, List[str]]:
        with open(os.path.join(self.db_dir, "img2txts.json")) as f:
            return json.load(f)


class RoutingImageDb:
    """Routes image lookups across several DetectFeatDbs by filename
    substring — the COCO-CN split-spanning case, where text dbs reference
    images living in either the train2014 or val2014 feature db (reference
    DetectFeatTxtTokDatasetCutDown._get_img_feat, data/data.py:308-315, and
    the COCO-CN ItmRank/Eval variants, data/itm.py:363-506)."""

    def __init__(self, routes: Dict[str, DetectFeatDb],
                 default: Optional[DetectFeatDb] = None):
        self.routes = routes
        self.default = default

    def _db(self, fname: str) -> DetectFeatDb:
        for pat, db in self.routes.items():
            if pat in fname:
                return db
        if self.default is not None:
            return self.default
        raise KeyError(f"no image db route for {fname}")

    def __getitem__(self, fname: str):
        return self._db(fname)[fname]

    def __contains__(self, fname: str):
        try:
            return fname in self._db(fname)
        except KeyError:
            return False

    def get_dump(self, fname: str):
        return self._db(fname).get_dump(fname)

    @property
    def name2nbb(self):
        class _Merged:
            def __init__(self, outer):
                self.outer = outer

            def __getitem__(self, fname):
                return self.outer._db(fname).name2nbb[fname]

            def keys(self):
                out = []
                for db in self.outer.routes.values():
                    out.extend(db.name2nbb.keys())
                if self.outer.default is not None:
                    out.extend(self.outer.default.name2nbb.keys())
                return out
        return _Merged(self)


class ImageDbGroup:
    """Cache of open DetectFeatDbs keyed by path (reference ImageLmdbGroup,
    data/data.py:398-413)."""

    def __init__(self, conf_th=0.2, max_bb=100, min_bb=10, num_bb=36,
                 native=True):
        self.args = (conf_th, max_bb, min_bb, num_bb)
        self.native = native
        self.cache: Dict[str, DetectFeatDb] = {}

    def __getitem__(self, path: str) -> DetectFeatDb:
        if path not in self.cache:
            self.cache[path] = DetectFeatDb(path, *self.args,
                                            native=self.native)
        return self.cache[path]


def get_ids_and_lens(db: TxtTokDb):
    """reference data/data.py:233-240."""
    return [db.id2len[i] for i in db.ids], list(db.ids)
