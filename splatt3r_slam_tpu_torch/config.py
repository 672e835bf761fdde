"""Config system: a YAML reader of its own, `inherit:` chains, deep merge,
and a module-global config dict.

Counterpart of `splatt3r_slam_tpu/config.py`. The machines the port runs on
may lack PyYAML, so `load_config` always reads files with `parse_yaml`, a
reader for the subset of YAML that the repository's config files use: block
maps by indentation, comments, single- and double-quoted and plain
scalars, YAML 1.1 booleans and nulls, decimal ints, floats including
``1e-8`` and ``1e+1`` (PyYAML with the extended float resolver that the JAX
package installs reads them so), and one-line flow lists of numbers. It
raises on anything outside that subset rather than guess. `DEFAULTS` holds
`config/base.yaml`'s values, and `config` starts as a copy of them.
"""

from __future__ import annotations

import copy
import pathlib
import re

# config/base.yaml, value for value
DEFAULTS: dict = {
    "use_calib": False,
    "single_thread": True,
    "dataset": {
        "subsample": 1,
        "img_downsample": 1,
        "center_principle_point": True,
    },
    "matching": {
        "max_iter": 10,
        "lambda_init": 1e-8,
        "convergence_thresh": 1e-6,
        "dist_thresh": 1e-1,
        "radius": 3,
        "dilation_max": 5,
        "match_stride": 2,
    },
    "tracking": {
        "pipeline_lag": 0,
        "min_match_frac": 0.05,
        "max_iters": 50,
        "C_conf": 0.0,
        "Q_conf": 1.5,
        "rel_error": 1e-3,
        "delta_norm": 1e-3,
        "huber": 1.345,
        "match_frac_thresh": 0.333,
        "sigma_ray": 0.003,
        "sigma_dist": 1e1,
        "sigma_pixel": 1.0,
        "sigma_depth": 1e1,
        "sigma_point": 0.05,
        "pixel_border": -10,
        "depth_eps": 1e-6,
        "filtering_mode": "weighted_pointmap",
        "filtering_score": "median",
    },
    "local_opt": {
        "pin": 1,
        "window_size": 1e6,
        "C_conf": 0.0,
        "Q_conf": 1.5,
        "min_match_frac": 0.1,
        "pixel_border": -10,
        "depth_eps": 1e-6,
        "max_iters": 10,
        "sigma_ray": 0.003,
        "sigma_dist": 1e1,
        "sigma_pixel": 1.0,
        "sigma_depth": 1e1,
        "sigma_point": 0.05,
        "delta_norm": 1e-8,
        "max_edges": 512,
        "gn_stride": 16,
        "reuse_tracking_edge": True,
    },
    "retrieval": {"k": 3, "min_thresh": 5e-3},
    "reloc": {"min_match_frac": 0.3, "strict": True},
}

# The extended float resolver of the JAX package's loader (a superset of
# PyYAML's own YAML 1.1 float pattern).
_FLOAT_RE = re.compile(
    """^(?:
     [-+]?(?:[0-9][0-9_]*)\\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\\.[0-9_]*
    |[-+]?\\.(?:inf|Inf|INF)
    |\\.(?:nan|NaN|NAN))$""",
    re.X,
)
_INT_RE = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
# other YAML 1.1 int forms (binary, octal, hex, base 60) and timestamps:
# PyYAML resolves them to values this reader does not produce
_OTHER_RE = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*)$")
_BOOLS = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                            "on", "On", "ON")}
_BOOLS.update({v: False for v in ("no", "No", "NO", "false", "False",
                                  "FALSE", "off", "Off", "OFF")})
_NULLS = ("", "~", "null", "Null", "NULL")
# a plain scalar may not start with these ("-", "?" and ":" only when a
# space or the end follows)
_INDICATORS = ",[]{}#&*!|>'\"%@`"
_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", "\\": "\\",
            '"': '"', "/": "/", " ": " "}

# Module-global config dict, re-pointed in place by set_global_config.
config: dict = copy.deepcopy(DEFAULTS)


class YAMLSubsetError(ValueError):
    """The text uses YAML outside the subset `parse_yaml` reads."""


def _plain(text: str, where: str):
    """Resolve an unquoted scalar as PyYAML's 1.1 resolvers would."""
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT_RE.match(text):
        return int(text.replace("_", ""))
    if _FLOAT_RE.match(text):
        if ":" in text:
            raise YAMLSubsetError(f"{where}: base-60 float {text!r}")
        t = text.replace("_", "").lower()
        if t.endswith((".inf", ".nan")):
            return float(t.replace(".", ""))
        return float(t)
    if _OTHER_RE.match(text) or text in ("=", "<<"):
        raise YAMLSubsetError(f"{where}: unsupported scalar {text!r}")
    if (text[0] in _INDICATORS or ": " in text or " #" in text
            or (text[0] in "-?:" and text[1:2] in ("", " "))):
        raise YAMLSubsetError(f"{where}: unsupported syntax {text!r}")
    return text


def _quoted(text: str, where: str):
    """(value, rest of the line) for a scalar that starts with a quote."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1: i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        if q == '"' and ch == "\\":
            esc = text[i + 1: i + 2]
            if esc not in _ESCAPES:
                raise YAMLSubsetError(f"{where}: escape \\{esc}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    raise YAMLSubsetError(f"{where}: unterminated quoted scalar")


def _strip_comment(text: str) -> str:
    """Drop a trailing comment: '#' at the start or after whitespace."""
    m = re.search(r"(^|\s)#", text)
    return (text[: m.start()] if m else text).rstrip()


def _value(text: str, where: str):
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, where)
        if _strip_comment(rest):
            raise YAMLSubsetError(f"{where}: text after a quoted scalar")
        return value
    text = _strip_comment(text)
    if text.startswith("["):
        if not text.endswith("]"):
            raise YAMLSubsetError(f"{where}: multi-line flow list")
        items = [s.strip() for s in text[1:-1].split(",")]
        if items == [""]:
            return []
        out = [_plain(s, where) if s else None for s in items]
        if not all(isinstance(v, (int, float)) and not isinstance(v, bool)
                   for v in out):
            raise YAMLSubsetError(f"{where}: flow list of non-numbers")
        return out
    return _plain(text, where)


def parse_yaml(text: str, name: str = "<yaml>"):
    """Parse the YAML subset described in the module docstring. Returns a
    dict (or None for a document with no keys, as `yaml.load` does)."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YAMLSubsetError(f"{where}: tab indentation")
        body = raw.strip()
        if not body or body.startswith("#"):
            continue
        if body in ("---", "...") or body.startswith(("- ", "%")) \
                or body == "-":
            raise YAMLSubsetError(f"{where}: unsupported syntax {body!r}")
        lines.append((len(raw) - len(raw.lstrip(" ")), body, where))
    if not lines:
        return None

    def block(i: int, indent: int):
        """Parse the map whose keys sit at `indent`, from line i."""
        out: dict = {}
        while i < len(lines):
            ind, body, where = lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLSubsetError(f"{where}: unexpected indentation")
            if body[0] in ("'", '"'):
                key, rest = _quoted(body, where)
                if not rest.startswith(":"):
                    raise YAMLSubsetError(f"{where}: expected ':'")
                rest = rest[1:]
            else:
                m = re.match(r"^([^:#]+?):(?:\s|$)", body + " ")
                if m is None:
                    raise YAMLSubsetError(f"{where}: expected 'key: value'")
                key = _plain(m.group(1), where)
                rest = body[m.end(0) - 1:] if len(body) >= m.end(0) else ""
            i += 1
            if _strip_comment(rest).strip() == "":
                if i < len(lines) and lines[i][0] > indent:
                    out[key], i = block(i, lines[i][0])
                else:
                    out[key] = None
            else:
                out[key] = _value(rest, where)
        return out, i

    out, i = block(0, lines[0][0])
    if i != len(lines):
        raise YAMLSubsetError(f"{lines[i][2]}: unexpected indentation")
    return out


def merge_config(base: dict, child: dict) -> dict:
    """Deep merge: child values override base, dicts merge recursively."""
    out = dict(base)
    for k, v in child.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_config(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str) -> dict:
    """Load YAML with `inherit:` parent chaining, set the global config."""
    path = pathlib.Path(path)
    cfg = parse_yaml(path.read_text(), str(path)) or {}
    if "inherit" in cfg:
        parent_rel = cfg.pop("inherit")
        # repo-root-relative in the reference; then cwd, then the file's dir
        parent = pathlib.Path(parent_rel)
        if not parent.exists():
            parent = pathlib.Path(__file__).resolve().parents[1] / parent_rel
        if not parent.exists():
            parent = path.parent / pathlib.Path(parent_rel).name
        cfg = merge_config(load_config(str(parent)), cfg)
    set_global_config(cfg)
    return cfg


def set_global_config(cfg: dict) -> None:
    """Point the module-global `config` at cfg's contents (in place)."""
    config.clear()
    config.update(cfg)


def reset_config() -> dict:
    """Restore the built-in base.yaml defaults into the global config."""
    set_global_config(copy.deepcopy(DEFAULTS))
    return config
