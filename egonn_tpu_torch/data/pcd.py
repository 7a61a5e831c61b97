"""PCD v0.7 point-cloud files (port of `egonn_tpu/data/pcd.py`): a reader for
ascii, binary and binary_compressed (LZF) data, and two xyz writers.

binary_compressed data is stored field-major: all x values, then all y
values, and so on, each field contiguous after decompression.  Its LZF is
decoded here in pure Python (the JAX package builds a C++ decoder into its
own tree), with a minimal encoder of literal runs for writing.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

_PCD_TYPE_TO_NUMPY: Dict[Tuple[str, int], np.dtype] = {
    ("F", 4): np.dtype("float32"),
    ("F", 8): np.dtype("float64"),
    ("U", 1): np.dtype("uint8"),
    ("U", 2): np.dtype("uint16"),
    ("U", 4): np.dtype("uint32"),
    ("U", 8): np.dtype("uint64"),
    ("I", 1): np.dtype("int8"),
    ("I", 2): np.dtype("int16"),
    ("I", 4): np.dtype("int32"),
    ("I", 8): np.dtype("int64"),
}


def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """Decompress `data` into exactly `expected_size` bytes; ValueError on a
    corrupt stream or a size mismatch."""
    out = bytearray()
    ip, n = 0, len(data)
    while ip < n:
        ctrl = data[ip]
        ip += 1
        if ctrl < 32:  # a literal run of ctrl + 1 bytes
            run = ctrl + 1
            out += data[ip : ip + run]
            ip += run
        else:  # a back-reference of length (ctrl >> 5) + 2, or more
            length = ctrl >> 5
            if length == 7:
                length += data[ip]
                ip += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - 1 - data[ip]
            ip += 1
            if ref < 0:
                raise ValueError("lzf: corrupt back-reference")
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    if len(out) != expected_size:
        raise ValueError(f"lzf: got {len(out)} bytes, expected {expected_size}")
    return bytes(out)


def lzf_compress(data: bytes) -> bytes:
    """A valid LZF stream of literal runs only (any conformant decoder reads
    it): for tests and PCD writing."""
    out = bytearray()
    for i in range(0, len(data), 32):
        chunk = data[i : i + 32]
        out.append(len(chunk) - 1)
        out += chunk
    return bytes(out)


def parse_header(lines: List[str]) -> Dict:
    metadata: Dict = {}
    for ln in lines:
        if ln.startswith("#") or len(ln) < 2:
            continue
        match = re.match(r"(\w+)\s+([\w\s\.\-]+)", ln)
        if not match:
            continue
        key, value = match.group(1).lower(), match.group(2)
        if key in ("fields", "type"):
            metadata[key] = value.split()
        elif key in ("size", "count"):
            metadata[key] = [int(v) for v in value.split()]
        elif key in ("width", "height", "points"):
            metadata[key] = int(value)
        elif key == "data":
            metadata[key] = value.strip().lower()
        else:
            metadata[key] = value.strip()
    metadata.setdefault("count", [1] * len(metadata.get("fields", [])))
    metadata.setdefault("points", metadata.get("width", 0) * metadata.get("height", 1))
    return metadata


def _build_dtype(metadata: Dict) -> np.dtype:
    fields, formats = [], []
    for name, c, t, s in zip(metadata["fields"], metadata["count"], metadata["type"],
                             metadata["size"]):
        np_type = _PCD_TYPE_TO_NUMPY[(t, s)]
        if c == 1:
            fields.append(name)
            formats.append(np_type)
        else:
            for i in range(c):
                fields.append(f"{name}_{i:04d}")
                formats.append(np_type)
    # padding fields may repeat a name ('_'): number the repeats
    seen: Dict[str, int] = {}
    uniq = []
    for f in fields:
        if f in seen:
            seen[f] += 1
            uniq.append(f"{f}_{seen[f]}")
        else:
            seen[f] = 0
            uniq.append(f)
    return np.dtype({"names": uniq, "formats": formats})


def read_pcd(file_pathname: str) -> Tuple[np.ndarray, Dict]:
    """Read a .pcd file: (structured array of points, header metadata)."""
    with open(file_pathname, "rb") as f:
        header_lines: List[str] = []
        while True:
            ln = f.readline().decode("ascii", errors="ignore").strip()
            header_lines.append(ln)
            if ln.lower().startswith("data"):
                break
        metadata = parse_header(header_lines)
        dtype = _build_dtype(metadata)
        n = metadata["points"]
        data_kind = metadata["data"]
        if data_kind == "ascii":
            body = f.read().decode("ascii", errors="ignore")
            arr = np.loadtxt(body.splitlines(), dtype=dtype, ndmin=1)
        elif data_kind == "binary":
            arr = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        elif data_kind == "binary_compressed":
            comp_size, uncomp_size = np.frombuffer(f.read(8), dtype=np.uint32)
            raw = lzf_decompress(f.read(int(comp_size)), int(uncomp_size))
            arr = np.empty(n, dtype=dtype)
            offset = 0
            for name in dtype.names:
                ft = dtype.fields[name][0]
                nbytes = ft.itemsize * n
                arr[name] = np.frombuffer(raw[offset : offset + nbytes], dtype=ft, count=n)
                offset += nbytes
        else:
            raise NotImplementedError(f"Unsupported PCD data kind: {data_kind}")
    return arr, metadata


def read_pcd_xyz(file_pathname: str) -> np.ndarray:
    """(N, 3) xyz of a PCD file, in the file's float type."""
    arr, _ = read_pcd(file_pathname)
    return np.stack([arr["x"], arr["y"], arr["z"]], axis=1)


def _xyz_header(n: int, data_kind: str) -> str:
    return ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
            "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA {data_kind}\n")


def write_pcd_binary(file_pathname: str, xyz: np.ndarray):
    """Write a binary PCD of float32 xyz."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    with open(file_pathname, "wb") as f:
        f.write(_xyz_header(len(xyz), "binary").encode("ascii"))
        f.write(xyz.tobytes())  # point-major x, y, z: the record layout


def write_pcd_binary_compressed(file_pathname: str, xyz: np.ndarray):
    """Write a binary_compressed PCD of float32 xyz (field-major, LZF literal
    runs): the read path of Apollo-SouthBay's files."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    raw = b"".join(np.ascontiguousarray(xyz[:, i]).tobytes() for i in range(3))
    comp = lzf_compress(raw)
    with open(file_pathname, "wb") as f:
        f.write(_xyz_header(len(xyz), "binary_compressed").encode("ascii"))
        f.write(np.array([len(comp), len(raw)], dtype=np.uint32).tobytes())
        f.write(comp)
