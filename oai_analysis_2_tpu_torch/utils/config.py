"""Training-config JSON and the hierarchical parameter dictionary (host
copies of `oai_analysis_2_tpu/utils/config.py:17-121`).

`ParameterDict` keeps nested categories, tuple-access sugar
`p[('key', default, 'comment')]` that records the default and its comment
on first access, externally set values apart from the ones used, and paired
`<name>.json` / `<name>_comments.json` output files.
"""

from __future__ import annotations

import json
from pathlib import Path


class ParameterDict:
    """Nested, self-documenting parameter dictionary."""

    def __init__(self, initial=None, name: str = "root"):
        self.ext = dict(initial) if initial else {}  # externally set / loaded
        self.int = {}  # values actually used (with defaults applied)
        self.com = {}  # comments / documentation
        self.name = name

    # -- access sugar ---------------------------------------------------------

    @staticmethod
    def _parse_key(key):
        if isinstance(key, tuple):
            if len(key) == 3:
                return key[0], key[1], key[2]
            if len(key) == 2:
                return key[0], key[1], ""
            raise ValueError("tuple key must be (name, default[, comment])")
        return key, None, None

    def __getitem__(self, key):
        name, default, comment = self._parse_key(key)
        if comment is not None:
            self.com[name] = comment
        if name in self.ext:
            value = self.ext[name]
        elif default is not None or isinstance(key, tuple):
            value = default
            self.ext[name] = value
        else:
            raise KeyError(f"parameter '{name}' not set and no default given")
        if isinstance(value, dict) and not isinstance(value, ParameterDict):
            sub = ParameterDict(value, name=name)
            sub.com = self.com.get(name + "__sub", {})
            self.ext[name] = sub
            value = sub
        self.int[name] = value
        return value

    def __setitem__(self, key, value):
        name, _, comment = self._parse_key(key)
        if comment:
            self.com[name] = comment
        self.ext[name] = value
        self.int[name] = value

    def __contains__(self, name):
        return name in self.ext

    # -- categories -----------------------------------------------------------

    def new_category(self, name: str, comment: str = "") -> "ParameterDict":
        if name not in self.ext or not isinstance(self.ext[name], ParameterDict):
            self.ext[name] = ParameterDict(name=name)
        if comment:
            self.com[name] = comment
        self.int[name] = self.ext[name]
        return self.ext[name]

    # -- (de)serialisation -----------------------------------------------------

    def _to_plain(self, which="ext"):
        src = getattr(self, which)
        out = {}
        for k, v in src.items():
            out[k] = v._to_plain(which) if isinstance(v, ParameterDict) else v
        return out

    def _comments_tree(self):
        out = {}
        for k, v in self.ext.items():
            if isinstance(v, ParameterDict):
                sub = v._comments_tree()
                if k in self.com:
                    sub["__doc__"] = self.com[k]
                out[k] = sub
            elif k in self.com:
                out[k] = self.com[k]
        return out

    def load_JSON(self, path) -> "ParameterDict":
        with open(path) as f:
            data = json.load(f)
        self.ext = data
        return self

    def write_JSON(self, path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self._to_plain("ext"), f, indent=4, sort_keys=True)

    def write_JSON_comments(self, path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self._comments_tree(), f, indent=4, sort_keys=True)

    def print_settings(self):
        print(json.dumps(self._to_plain("ext"), indent=2, sort_keys=True, default=str))


def load_json_to_dict(json_file) -> dict:
    """Load a training-config JSON into a plain dict."""
    with open(json_file) as f:
        return json.load(f)
