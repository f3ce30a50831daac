"""Point clouds and their PLY reader/writer (host side).

The reader takes ascii and binary (little or big endian) PLY with xyz and
optional rgb, normals and reflectance, as the reference's PLY handling does
(reference: source/lib/PccLibCommon/include/PCCPointSet.h:42 read/write);
`write_ply` writes binary little-endian PLY.  Pure numpy, vectorised.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


class PointCloudData:
    """Host-side point cloud: integer positions + optional uint8 RGB colors,
    float32 normals and uint16 reflectances."""

    def __init__(
        self,
        positions: np.ndarray,
        colors: Optional[np.ndarray] = None,
        normals: Optional[np.ndarray] = None,
        reflectances: Optional[np.ndarray] = None,
    ):
        self.positions = np.asarray(positions)
        self.colors = None if colors is None else np.asarray(colors, dtype=np.uint8)
        self.normals = None if normals is None else np.asarray(normals, dtype=np.float32)
        self.reflectances = (None if reflectances is None
                             else np.asarray(reflectances, dtype=np.uint16))

    @property
    def point_count(self) -> int:
        return int(self.positions.shape[0])


def read_ply(path: str | Path) -> PointCloudData:
    """PLY (ascii or binary) -> PointCloudData; the vertex element's x, y, z
    and, where present, red/green/blue, nx/ny/nz and reflectance."""
    path = Path(path)
    data = path.read_bytes()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:end].decode("ascii", errors="replace")
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = "ascii"
    count = 0
    props: list[Tuple[str, str]] = []  # (type, name) of the vertex element
    in_vertex = False
    for line in header.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                count = int(tok[2])
        elif tok[0] == "property" and in_vertex:
            if tok[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((tok[1], tok[2]))

    if fmt == "ascii":
        arr = np.array(body.decode("ascii").split(), dtype=np.float64)
        arr = arr[: count * len(props)].reshape(count, len(props))
        cols = {n: arr[:, i] for i, (_, n) in enumerate(props)}
    else:
        byte_order = "<" if "little" in fmt else ">"
        dt = np.dtype([(n, byte_order + _PLY_DTYPES[t]) for t, n in props])
        rec = np.frombuffer(body, dtype=dt, count=count)
        cols = {n: rec[n] for _, n in props}

    pos = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    colors = normals = refl = None
    if all(k in cols for k in ("red", "green", "blue")):
        colors = np.stack([cols["red"], cols["green"], cols["blue"]], axis=1).astype(np.uint8)
    if all(k in cols for k in ("nx", "ny", "nz")):
        normals = np.stack([cols["nx"], cols["ny"], cols["nz"]], axis=1).astype(np.float32)
    if "reflectance" in cols:
        refl = cols["reflectance"].astype(np.uint16)
    return PointCloudData(pos, colors, normals, refl)


def write_ply(path: str | Path, pc: PointCloudData) -> None:
    """Binary little-endian PLY: uint16 x, y, z (+ float nx, ny, nz, uchar
    red, green, blue, uint16 reflectance, where present)."""
    lines = [
        "ply",
        "format binary_little_endian 1.0",
        "comment generated by vpcc_tpu_torch",
        f"element vertex {pc.point_count}",
        "property uint16 x",
        "property uint16 y",
        "property uint16 z",
    ]
    fields = [(k, pc.positions[:, i].astype(np.uint16)) for i, k in enumerate("xyz")]
    if pc.normals is not None:
        for i, ax in enumerate("xyz"):
            lines.append(f"property float n{ax}")
            fields.append((f"n{ax}", pc.normals[:, i].astype(np.float32)))
    if pc.colors is not None:
        for i, cname in enumerate(("red", "green", "blue")):
            lines.append(f"property uchar {cname}")
            fields.append((cname, pc.colors[:, i]))
    if pc.reflectances is not None:
        lines.append("property uint16 reflectance")
        fields.append(("reflectance", pc.reflectances))
    lines.append("end_header")
    header = "\n".join(lines) + "\n"
    rec = np.rec.fromarrays(
        [v for _, v in fields],
        dtype=[(k, "<" + v.dtype.str[1:]) for k, v in fields],
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
