"""Darknet .cfg parser and .weights loader.

The port's own copy of ``stereo_semantic_vo_tpu.io.darknet`` (numpy only,
unchanged): the cfg becomes a list of section dicts, the weights file a
dict of numpy arrays keyed by layer index, ``{index: {"w": HWIO, "b":
(n,)}}``.  That numpy dict is what carries weights between the two
packages; ``models/yolo.YoloNet`` turns the HWIO weights into OIHW once.
It replaces darknet's file handling (parser.c:730 parse_network_cfg,
:1297 load_weights).

Weight file layout (parser.c load_weights_upto / load_convolutional_weights):
  header: int32 major, minor, revision; then seen as int64 if
  major*10+minor >= 2 else int32.  Per convolutional layer, in cfg order:
  biases(n) [, scales(n), rolling_mean(n), rolling_var(n) if batch_normalize]
  then weights(n*c*size*size) in OIHW.  All little-endian float32.

Batch-norm is folded into the conv weights at load time (inference-only, as
the VO pipeline uses it) so the forward pass is conv+bias+activation.
"""

from __future__ import annotations

import io as _io
from typing import Any

import numpy as np

BN_EPS = 1e-5  # kept for backward-compat imports; folding uses bn_inv_std


def bn_inv_std(var: np.ndarray) -> np.ndarray:
    """Darknet's exact normalization factor: eps is added to the *stddev*
    (blas.c normalize_cpu :154, ``(x-mean)/(sqrt(var)+1e-6)``), not to the
    variance as in most frameworks."""
    return 1.0 / (np.sqrt(var) + 1e-6)


def parse_cfg(text: str) -> list[dict[str, Any]]:
    """Parse darknet cfg text into [{'type': section, key: value, ...}, ...].

    Values are int/float/str or tuples of those for comma lists.
    """
    sections: list[dict[str, Any]] = []
    cur: dict[str, Any] | None = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith(("#", ";")):
            continue
        if line.startswith("["):
            cur = {"type": line.strip("[]").strip()}
            sections.append(cur)
            continue
        if cur is None or "=" not in line:
            continue
        key, val = line.split("=", 1)
        key = key.strip()
        val = val.strip()
        if "," in val:
            cur[key] = tuple(_scalar(v) for v in val.split(",") if v.strip())
        else:
            cur[key] = _scalar(val)
    return sections


def _scalar(v: str):
    v = v.strip()
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def _conv_out_channels(sec: dict) -> int:
    return int(sec.get("filters", 1))


def conv_layer_shapes(sections: list[dict]) -> list[dict]:
    """Walk the graph to determine each conv layer's (n, c, size) — needed to
    slice the flat weights file.  Supports the layer set of yolov2/yolov2-tiny/
    yolov3/yolov3-tiny: convolutional, maxpool, route, shortcut, upsample,
    region, yolo."""
    infos = []
    channels: list[int] = []  # output channels per layer index (net excluded)
    c_in = int(sections[0].get("channels", 3))
    for sec in sections[1:]:
        t = sec["type"]
        if t == "convolutional":
            n = int(sec.get("filters", 1))
            size = int(sec.get("size", 1))
            infos.append(
                {
                    "index": len(channels),
                    "n": n,
                    "c": c_in,
                    "size": size,
                    "bn": int(sec.get("batch_normalize", 0)) == 1,
                    "stride": int(sec.get("stride", 1)),
                    "pad": int(sec.get("pad", 0)),
                    "activation": sec.get("activation", "linear"),
                }
            )
            c_out = n
        elif t == "route":
            layers = sec.get("layers", ())
            if not isinstance(layers, tuple):
                layers = (layers,)
            idxs = [l if l >= 0 else len(channels) + l for l in layers]
            c_out = sum(channels[i] for i in idxs)
        elif t in ("maxpool", "upsample", "shortcut", "region", "yolo"):
            c_out = c_in
        else:
            c_out = c_in
        channels.append(c_out)
        c_in = c_out
    return infos


def load_weights(
    cfg_sections: list[dict], weights_bytes: bytes
) -> dict[int, dict[str, np.ndarray]]:
    """Parse a darknet .weights blob into folded (weight, bias) per conv layer.

    Returns {layer_index: {'w': (size, size, c, n) HWIO float32, 'b': (n,)}}.
    """
    buf = _io.BytesIO(weights_bytes)
    major, minor, revision = np.frombuffer(buf.read(12), dtype="<i4")
    if major * 10 + minor >= 2 and major < 1000 and minor < 1000:
        buf.read(8)  # seen: size_t
    else:
        buf.read(4)  # seen: int

    def read_f32(count):
        data = np.frombuffer(buf.read(4 * count), dtype="<f4")
        if data.size != count:
            raise ValueError(f"weights file truncated: wanted {count}, got {data.size}")
        return data.astype(np.float32)

    params: dict[int, dict[str, np.ndarray]] = {}
    for info in conv_layer_shapes(cfg_sections):
        n, c, size = info["n"], info["c"], info["size"]
        biases = read_f32(n)
        if info["bn"]:
            scales = read_f32(n)
            mean = read_f32(n)
            var = read_f32(n)
        w = read_f32(n * c * size * size).reshape(n, c, size, size)  # OIHW
        if info["bn"]:
            inv_std = bn_inv_std(var)
            w = w * (scales * inv_std)[:, None, None, None]
            b = biases - scales * mean * inv_std
        else:
            b = biases
        # OIHW -> HWIO, the layout the JAX package's params use
        params[info["index"]] = {"w": np.transpose(w, (2, 3, 1, 0)).copy(), "b": b}
    return params


def load_weights_raw(
    cfg_sections: list[dict], weights_bytes: bytes
) -> dict[int, dict[str, np.ndarray]]:
    """Parse a darknet .weights blob *without* folding batch-norm — the
    trainable form (parser.c load_convolutional_weights layout).

    Returns {layer_index: {'w': HWIO, 'b': (n,)} plus, for batch-normalized
    layers, 'scales'/'mean'/'var' (the rolling statistics)}.
    """
    buf = _io.BytesIO(weights_bytes)
    major, minor, revision = np.frombuffer(buf.read(12), dtype="<i4")
    if major * 10 + minor >= 2 and major < 1000 and minor < 1000:
        buf.read(8)
    else:
        buf.read(4)

    def read_f32(count):
        data = np.frombuffer(buf.read(4 * count), dtype="<f4")
        if data.size != count:
            raise ValueError(f"weights file truncated: wanted {count}, got {data.size}")
        return data.astype(np.float32)

    params: dict[int, dict[str, np.ndarray]] = {}
    for info in conv_layer_shapes(cfg_sections):
        n, c, size = info["n"], info["c"], info["size"]
        p: dict[str, np.ndarray] = {"b": read_f32(n)}
        if info["bn"]:
            p["scales"] = read_f32(n)
            p["mean"] = read_f32(n)
            p["var"] = read_f32(n)
        w = read_f32(n * c * size * size).reshape(n, c, size, size)
        p["w"] = np.transpose(w, (2, 3, 1, 0)).copy()  # OIHW -> HWIO
        params[info["index"]] = p
    return params


def fold_params(
    raw: dict[int, dict[str, np.ndarray]],
) -> dict[int, dict[str, np.ndarray]]:
    """Fold rolling batch-norm statistics of trainable params into inference
    (w, b) pairs — the transform ``load_weights`` applies at read time."""
    out: dict[int, dict[str, np.ndarray]] = {}
    for idx, p in raw.items():
        w = np.asarray(p["w"])
        b = np.asarray(p["b"])
        if "scales" in p:
            inv_std = bn_inv_std(np.asarray(p["var"]))
            w = w * (np.asarray(p["scales"]) * inv_std)[None, None, None, :]
            b = b - np.asarray(p["scales"]) * np.asarray(p["mean"]) * inv_std
        out[idx] = {"w": w, "b": b}
    return out


def random_weights_raw(
    cfg_sections: list[dict], seed: int = 0
) -> dict[int, dict[str, np.ndarray]]:
    """He-initialized *trainable* params (unfolded BN: scales=1, mean=0,
    var=1), matching darknet's make_convolutional_layer init."""
    rng = np.random.RandomState(seed)
    params = {}
    for info in conv_layer_shapes(cfg_sections):
        n, c, size = info["n"], info["c"], info["size"]
        std = np.sqrt(2.0 / (c * size * size))
        p = {
            "w": rng.normal(0, std, (size, size, c, n)).astype(np.float32),
            "b": np.zeros(n, np.float32),
        }
        if info["bn"]:
            p["scales"] = np.ones(n, np.float32)
            p["mean"] = np.zeros(n, np.float32)
            p["var"] = np.ones(n, np.float32)
        params[info["index"]] = p
    return params


def save_weights_raw(
    cfg_sections: list[dict], raw: dict[int, dict[str, np.ndarray]], seen: int = 0
) -> bytes:
    """Serialize trainable params (HWIO 'w', 'b', optional BN stats) back to
    darknet .weights bytes (parser.c save_convolutional_weights layout) — the
    checkpoint format the reference's training path writes."""
    out = _io.BytesIO()
    out.write(np.array([0, 2, 0], dtype="<i4").tobytes())
    out.write(np.array([seen], dtype="<i8").tobytes())
    for info in conv_layer_shapes(cfg_sections):
        p = raw[info["index"]]
        out.write(np.asarray(p["b"], "<f4").tobytes())
        if info["bn"]:
            out.write(np.asarray(p["scales"], "<f4").tobytes())
            out.write(np.asarray(p["mean"], "<f4").tobytes())
            out.write(np.asarray(p["var"], "<f4").tobytes())
        w_oihw = np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))
        out.write(w_oihw.astype("<f4").tobytes())
    return out.getvalue()


def random_weights(
    cfg_sections: list[dict], seed: int = 0
) -> dict[int, dict[str, np.ndarray]]:
    """He-initialized folded params with the same structure as load_weights —
    for benchmarking / tests when no .weights file is available."""
    rng = np.random.RandomState(seed)
    params = {}
    for info in conv_layer_shapes(cfg_sections):
        n, c, size = info["n"], info["c"], info["size"]
        std = np.sqrt(2.0 / (c * size * size))
        params[info["index"]] = {
            "w": rng.normal(0, std, (size, size, c, n)).astype(np.float32),
            "b": np.zeros(n, np.float32),
        }
    return params


def save_weights(
    cfg_sections: list[dict], params_unfolded: dict[int, dict[str, np.ndarray]]
) -> bytes:
    """Serialize raw (unfolded) darknet params back to .weights bytes — used
    by tests to validate the loader against a known roundtrip."""
    out = _io.BytesIO()
    out.write(np.array([0, 2, 0], dtype="<i4").tobytes())
    out.write(np.array([0], dtype="<i8").tobytes())
    for info in conv_layer_shapes(cfg_sections):
        p = params_unfolded[info["index"]]
        out.write(p["biases"].astype("<f4").tobytes())
        if info["bn"]:
            out.write(p["scales"].astype("<f4").tobytes())
            out.write(p["mean"].astype("<f4").tobytes())
            out.write(p["var"].astype("<f4").tobytes())
        out.write(p["w_oihw"].astype("<f4").tobytes())
    return out.getvalue()
