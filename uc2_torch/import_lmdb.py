"""Convert the original UC2 release's LMDB databases into U2S stores (port
of the repository's scripts/import_lmdb.py).

    python -m uc2_torch.import_lmdb txt /path/to/txt_db /out/txt_db
    python -m uc2_torch.import_lmdb img /path/to/img_db /out/img_db [--npz]

The release keeps text records as LZ4 frames of msgpack and image
features as compressed npz (``--npz``) or msgpack-numpy values, each in
an LMDB environment. The importer reads the environment with the port's
pure-Python reader (``data/lmdbio.py``), the frames with ``data/lz4frame.py`` (the system liblz4), the
msgpack with the store's own codec (``data/store.py``: no msgpack wheel is
needed), and writes ``txt.u2s`` / ``feat.u2s`` through ``StoreWriter``
with the sidecar JSON files, after which the drivers read no LMDB.
"""

from __future__ import annotations

import argparse
import io
import os
import shutil

import numpy as np

from uc2_torch.data.lmdbio import LmdbReader
from uc2_torch.data.lz4frame import decompress
from uc2_torch.data.store import StoreWriter, unpack_value

TXT_SIDECARS = ("id2len.json", "meta.json", "txt2img.json", "img2txts.json")


def lmdb_items(src: str):
    """(str key, bytes value) of every record of an LMDB environment."""
    for k, v in LmdbReader(src).items():
        yield k.decode("utf-8"), v


def decode_msgpack_numpy(obj):
    """msgpack-numpy's ndarray maps ({"nd": True, "type", "shape",
    "data"}, keys as bytes or str) as numpy arrays, through dicts and
    lists."""
    if isinstance(obj, dict):
        if obj.get(b"nd") is True or obj.get("nd") is True:
            def g(k):
                v = obj.get(k.encode())
                return v if v is not None else obj.get(k)
            return np.frombuffer(
                g("data"), dtype=np.dtype(g("type"))).reshape(g("shape"))
        return {k: decode_msgpack_numpy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_msgpack_numpy(v) for v in obj]
    return obj


def import_txt(src: str, dst: str) -> int:
    """Text records into ``dst/txt.u2s`` plus the sidecars; returns the
    record count."""
    os.makedirs(dst, exist_ok=True)
    n = 0
    with StoreWriter(os.path.join(dst, "txt.u2s")) as w:
        for k, value in lmdb_items(src):
            w.put(k, unpack_value(decompress(bytes(value))))
            n += 1
    for side in TXT_SIDECARS:
        if os.path.exists(os.path.join(src, side)):
            shutil.copy(os.path.join(src, side), os.path.join(dst, side))
    print(f"imported txt db {src} ({n} records) -> {dst}")
    return n


def import_img(src: str, dst: str, npz: bool = False) -> int:
    """Image records into ``dst/feat.u2s`` with the ``__keys__`` record
    and the ``nbb_*.json`` sidecars (in the environment's directory or one
    level up, as the release lays them out); returns the image count."""
    os.makedirs(dst, exist_ok=True)
    keys = []
    with StoreWriter(os.path.join(dst, "feat.u2s")) as w:
        for k, value in lmdb_items(src):
            if k == "__keys__":
                continue
            if npz:
                with io.BytesIO(bytes(value)) as reader:
                    dump = np.load(reader, allow_pickle=True)
                    rec = {f: np.asarray(dump[f]) for f in dump.files}
            else:
                rec = decode_msgpack_numpy(unpack_value(bytes(value)))
            w.put(k, rec)
            keys.append(k)
        w.put("__keys__", keys)
    for root in (src, os.path.dirname(src.rstrip("/"))):
        for side in os.listdir(root) if os.path.isdir(root) else []:
            if side.startswith("nbb_") and side.endswith(".json"):
                shutil.copy(os.path.join(root, side),
                            os.path.join(dst, side))
    print(f"imported img db {src} ({len(keys)} images) -> {dst}")
    return len(keys)


def main(argv=None):
    ap = argparse.ArgumentParser(description="LMDB databases to U2S stores")
    ap.add_argument("kind", choices=["txt", "img"])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--npz", action="store_true",
                    help="image values are compressed npz, not msgpack")
    args = ap.parse_args(argv)
    if args.kind == "txt":
        import_txt(args.src, args.dst)
    else:
        import_img(args.src, args.dst, args.npz)


if __name__ == "__main__":
    main()
