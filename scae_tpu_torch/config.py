"""Layered config: YAML config groups and dotted overrides (counterpart of
scae_tpu/config.py's ``load_config``).

The root ``configs/config.yaml`` names group entries in its ``defaults``
list (``model/<name>.yaml``, ``optimizer/<name>.yaml``); they are merged in
order, the root's own keys last. Overrides ``a.b.c=value`` (values parsed
as JSON, else ``null``/``none`` or a bare string) create keys that are
missing; ``group=entry`` swaps a group file.

The port keeps its own copy of the shipped YAML files under
``scae_tpu_torch/configs/`` and reads them with ``read_yaml``, a small
reader of the part of YAML those files use, so that it needs no PyYAML:
block mappings, block lists (of scalars or of mappings), flow lists of
scalars (``[1, 40, 40]``), full-line and trailing ``#`` comments, and the
YAML 1.1 scalars PyYAML's ``safe_load`` resolves: ints, floats (with a
dot: ``1e-2`` is a string there, ``3.0e-5`` a float), booleans, null and
bare or quoted strings. Anything else (anchors, tags, block scalars, flow
mappings, nested flow lists, tabs) raises, rather than being read
otherwise than PyYAML would read it.
"""

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_value(text: str) -> Any:
    try:
        return json.loads(text)
    except (json.JSONDecodeError, ValueError):
        if text.lower() in ("null", "none"):
            return None
        return text


def _set_dotted(cfg: Dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"cannot override into scalar at {k}")
    node[keys[-1]] = value


def load_config(name: str = "config",
                overrides: Optional[List[str]] = None,
                config_dir: Optional[str] = None) -> Dict:
    """Compose <config_dir>/<name>.yaml with its defaults list + overrides.

    `defaults: [{group: entry}, ...]` pulls <config_dir>/<group>/<entry>.yaml
    under the key <group>. Overrides are `dotted.path=value` strings
    (JSON-parsed values), applied last; `group=entry` swaps a group file.
    """
    config_dir = config_dir or CONFIG_DIR
    overrides = list(overrides or [])

    root = _load_yaml(os.path.join(config_dir, f"{name}.yaml"))
    defaults = root.pop("defaults", [])

    # `group=entry` overrides swap default group selections
    group_swaps = {}
    passthrough = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        if "." not in key and os.path.isdir(os.path.join(config_dir, key)):
            group_swaps[key] = val
        else:
            passthrough.append(ov)

    cfg: Dict = {}
    for entry in defaults:
        if not (isinstance(entry, dict) and len(entry) == 1):
            raise ValueError(f"a defaults entry must be one group: entry "
                             f"pair, got {entry!r}")
        (group, selection), = entry.items()
        selection = group_swaps.get(group, selection)
        group_cfg = _load_yaml(
            os.path.join(config_dir, group, f"{selection}.yaml"))
        cfg = _deep_merge(cfg, {group: group_cfg})

    cfg = _deep_merge(cfg, root)

    for ov in passthrough:
        key, sep, val = ov.partition("=")
        if not sep:
            raise ValueError(f"override must be key=value: {ov}")
        _set_dotted(cfg, key, _parse_value(val))
    return cfg


def _load_yaml(path: str) -> Dict:
    with open(path, encoding="utf-8") as f:
        out = read_yaml(f.read(), path)
    return out or {}


# ------------------------------------------------------------ YAML subset

# YAML 1.1 implicit scalars, as PyYAML's resolver writes them
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                        |[-+]?\.(?:inf|Inf|INF)
                        |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
# YAML 1.1 forms this reader does not take: other int bases, sexagesimal
_UNSUPPORTED_NUMBER = re.compile(
    r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
    r"|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$")
_TRUE = ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")
_FALSE = ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")
_NULL = ("", "~", "null", "Null", "NULL")


class YamlSubsetError(ValueError):
    """Text outside the part of YAML that ``read_yaml`` takes."""


def _scalar(text: str, where: str) -> Any:
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        if text[0] == '"' and "\\" in body:
            raise YamlSubsetError(f"{where}: escapes in quoted strings")
        if text[0] == "'":
            body = body.replace("''", "'")
        return body
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return float(t)
    if _UNSUPPORTED_NUMBER.match(text):
        raise YamlSubsetError(f"{where}: number form {text!r}")
    if (text[0] in "&*!|>{[]}%@`\"'" or text in ("-", "?")
            or text.startswith(("- ", "? ", ": "))):
        raise YamlSubsetError(f"{where}: unsupported value {text!r}")
    return text


def _value(text: str, where: str) -> Any:
    """A scalar or a flow list of scalars."""
    if text.startswith("["):
        if not text.endswith("]"):
            raise YamlSubsetError(f"{where}: unclosed flow list {text!r}")
        inner = text[1:-1].strip()
        if "[" in inner or "{" in inner:
            raise YamlSubsetError(f"{where}: nested flow collections")
        if not inner:
            return []
        items = [s.strip() for s in inner.split(",")]
        if items[-1] == "":
            items.pop()   # a trailing comma
        return [_scalar(s, where) for s in items]
    if text == "{}":
        return {}
    return _scalar(text, where)


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (one at the start or after a
    space, outside quotes) and without trailing blanks."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " [,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str, where: str) -> Optional[Tuple[str, str]]:
    """(key, rest) of ``key: rest`` or ``key:``, else None."""
    m = re.match(r"^([^\s'\"\[\]{}#,][^:]*?|'[^']*'|\"[^\"]*\"):(?:\s+(.*))?$",
                 text)
    if m is None:
        return None
    key = m.group(1).strip()
    if key[0] in "'\"":
        key = key[1:-1]
    elif key.startswith(("? ", "- ")):
        raise YamlSubsetError(f"{where}: unsupported key {key!r}")
    return key, (m.group(2) or "").strip()


def read_yaml(text: str, name: str = "<yaml>") -> Any:
    """Parse ``text``, written in the part of YAML the shipped config files
    use, as PyYAML's ``safe_load`` would."""
    lines: List[List] = []     # [indent, text, line number]
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"{name}:{n}: tab in indentation")
        body = _strip_comment(raw)
        if body.strip() in ("---", "..."):
            raise YamlSubsetError(f"{name}:{n}: document markers")
        if body.strip():
            lines.append([len(body) - len(body.lstrip(" ")), body.strip(), n])
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0], name)
    if i != len(lines):
        raise YamlSubsetError(f"{name}:{lines[i][2]}: unexpected indentation")
    return value


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines, i, indent, name):
    if _is_item(lines[i][1]):
        return _list(lines, i, indent, name)
    if _split_key(lines[i][1], f"{name}:{lines[i][2]}") is None:
        # a lone scalar (a document or an item's nested value)
        where = f"{name}:{lines[i][2]}"
        return _value(lines[i][1], where), i + 1
    return _mapping(lines, i, indent, name)


def _nested(lines, i, indent, name, allow_same_indent_list):
    """The value of a key or item whose text ended at line i - 1: the block
    below it, or None."""
    if i < len(lines):
        ind, text, _ = lines[i]
        if ind > indent or (allow_same_indent_list and ind == indent
                            and _is_item(text)):
            return _block(lines, i, ind, name)
    return None, i


def _mapping(lines, i, indent, name):
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        _, text, n = lines[i]
        where = f"{name}:{n}"
        if _is_item(text):
            raise YamlSubsetError(f"{where}: a list item inside a mapping")
        kv = _split_key(text, where)
        if kv is None:
            raise YamlSubsetError(f"{where}: expected key: value, got "
                                  f"{text!r}")
        key, rest = kv
        if rest:
            out[key] = _value(rest, where)
            i += 1
        else:
            out[key], i = _nested(lines, i + 1, indent, name, True)
    if i < len(lines) and lines[i][0] > indent:
        raise YamlSubsetError(f"{name}:{lines[i][2]}: unexpected indentation")
    return out, i


def _list(lines, i, indent, name):
    out: List[Any] = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        _, text, n = lines[i]
        where = f"{name}:{n}"
        rest = text[1:].strip()
        if not rest:
            value, i = _nested(lines, i + 1, indent, name, False)
        elif _is_item(rest):
            raise YamlSubsetError(f"{where}: nested inline list items")
        elif _split_key(rest, where) is not None:
            # a mapping whose first key shares the item's line: read it as
            # the block it would be with the dash replaced by a blank
            col = indent + (len(text) - len(rest))
            lines[i] = [col, rest, n]
            value, i = _mapping(lines, i, col, name)
        else:
            value, i = _value(rest, where), i + 1
        out.append(value)
    if i < len(lines) and lines[i][0] > indent:
        raise YamlSubsetError(f"{name}:{lines[i][2]}: unexpected indentation")
    return out, i
