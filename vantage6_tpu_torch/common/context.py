"""Instance contexts + configuration manager.

Parity: vantage6-common ``AppContext``/``NodeContext``/``ServerContext`` and
``ConfigurationManager`` (SURVEY.md §2 item 22) — an *instance* (one named
server / node / store deployment) owns a YAML config file in a well-known
directory plus per-instance log/data dirs; contexts locate, validate and
expose these.

Directory layout (XDG-style instead of appdirs)::

    $XDG_CONFIG_HOME/vantage6_tpu/<kind>/<name>.yaml   config
    $XDG_DATA_HOME/vantage6_tpu/<kind>/<name>/         data dir
    $XDG_STATE_HOME/vantage6_tpu/<kind>/<name>/log/    logs

The port's copy of ``vantage6_tpu/common/context.py``, with the same
directory layout (an instance configured for one package is found by the
other). PyYAML is imported where a file is read or written, so the module
imports without it; ``ConfigurationManager.validate`` needs none.
"""
from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Any, Callable

from vantage6_tpu_torch.common.log import setup_logging


class ConfigurationError(Exception):
    pass


def _xdg(var: str, default: str) -> Path:
    return Path(os.environ.get(var, os.path.expanduser(default)))


def config_root(system_folders: bool = False) -> Path:
    if system_folders:
        return Path("/etc/vantage6_tpu")
    return _xdg("XDG_CONFIG_HOME", "~/.config") / "vantage6_tpu"


def data_root(system_folders: bool = False) -> Path:
    if system_folders:
        return Path("/var/lib/vantage6_tpu")
    return _xdg("XDG_DATA_HOME", "~/.local/share") / "vantage6_tpu"


def state_root(system_folders: bool = False) -> Path:
    if system_folders:
        return Path("/var/log/vantage6_tpu")
    return _xdg("XDG_STATE_HOME", "~/.local/state") / "vantage6_tpu"


class Configuration(dict):
    """A validated config mapping with attribute access."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e


# Per-kind required keys + per-key validators (a lightweight stand-in for the
# reference's `schema` package validation).
Validator = Callable[[Any], bool]
SCHEMAS: dict[str, dict[str, tuple[bool, Validator]]] = {
    "node": {
        "api_url": (True, lambda v: isinstance(v, str) and v != ""),
        "api_key": (True, lambda v: isinstance(v, str) and v != ""),
        "databases": (False, lambda v: isinstance(v, list)),
        "encryption": (False, lambda v: isinstance(v, dict)),
        "policies": (False, lambda v: isinstance(v, dict)),
        "logging": (False, lambda v: isinstance(v, dict)),
    },
    "server": {
        "port": (False, lambda v: isinstance(v, int)),
        "uri": (False, lambda v: isinstance(v, str)),
        "jwt_secret": (False, lambda v: isinstance(v, str)),
        "logging": (False, lambda v: isinstance(v, dict)),
    },
    "store": {
        "port": (False, lambda v: isinstance(v, int)),
        "uri": (False, lambda v: isinstance(v, str)),
        "logging": (False, lambda v: isinstance(v, dict)),
    },
    "federation": {},  # validated by core.config.FederationConfig instead
}


class ConfigurationManager:
    """Loads + validates one instance's YAML config."""

    def __init__(self, kind: str):
        if kind not in SCHEMAS:
            raise ConfigurationError(
                f"unknown config kind {kind!r}; expected {sorted(SCHEMAS)}"
            )
        self.kind = kind

    def load(self, path: str | Path) -> Configuration:
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        if not isinstance(raw, dict):
            raise ConfigurationError(f"{path}: config must be a mapping")
        return self.validate(raw, source=str(path))

    def validate(
        self, raw: dict[str, Any], source: str = "<dict>"
    ) -> Configuration:
        schema = SCHEMAS[self.kind]
        for key, (required, check) in schema.items():
            if key not in raw:
                if required:
                    raise ConfigurationError(
                        f"{source}: missing required key {key!r}"
                    )
                continue
            if not check(raw[key]):
                raise ConfigurationError(f"{source}: invalid value for {key!r}")
        # Deep copy so interpolation never mutates the caller's dict — a
        # saved config must keep its `${VAR}` placeholders, not the resolved
        # secrets.
        cfg = Configuration(copy.deepcopy(raw))
        _interp_env_deep(cfg)
        return cfg

    def save(self, cfg: dict[str, Any], path: str | Path) -> None:
        import yaml

        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(dict(cfg), f, sort_keys=False)


def _interp_env_deep(obj: Any) -> None:
    """In-place `${VAR}` interpolation in all string values."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, str):
                obj[k] = os.path.expandvars(v)
            else:
                _interp_env_deep(v)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            if isinstance(v, str):
                obj[i] = os.path.expandvars(v)
            else:
                _interp_env_deep(v)


class AppContext:
    """Base context: name + kind -> config, data dir, log dir, logger."""

    kind = "federation"

    def __init__(
        self,
        name: str,
        config_path: str | Path | None = None,
        system_folders: bool = False,
    ):
        self.name = name
        self.system_folders = system_folders
        self.config_path = Path(
            config_path
            if config_path is not None
            else self.default_config_path(name, system_folders)
        )
        if not self.config_path.exists():
            raise ConfigurationError(
                f"no {self.kind} configuration {name!r} at {self.config_path}"
            )
        self.config = ConfigurationManager(self.kind).load(self.config_path)
        self.log = setup_logging(
            f"{self.kind}/{name}",
            level=(self.config.get("logging", {}) or {}).get("level", "INFO"),
            log_dir=self.log_dir,
        )

    # ------------------------------------------------------------------ paths
    @classmethod
    def default_config_path(cls, name: str, system_folders: bool = False) -> Path:
        return config_root(system_folders) / cls.kind / f"{name}.yaml"

    @classmethod
    def available_configurations(cls, system_folders: bool = False) -> list[str]:
        d = config_root(system_folders) / cls.kind
        return sorted(p.stem for p in d.glob("*.yaml")) if d.exists() else []

    @classmethod
    def config_exists(cls, name: str, system_folders: bool = False) -> bool:
        return cls.default_config_path(name, system_folders).exists()

    @classmethod
    def create(
        cls,
        name: str,
        config: dict[str, Any],
        system_folders: bool = False,
        **kw: Any,
    ) -> "AppContext":
        """Write a new instance config and return its context."""
        path = cls.default_config_path(name, system_folders)
        if path.exists():
            raise ConfigurationError(f"{cls.kind} config {name!r} exists")
        manager = ConfigurationManager(cls.kind)
        manager.validate(config, source=f"create({name!r})")
        manager.save(config, path)
        return cls(name, system_folders=system_folders, **kw)

    @property
    def data_dir(self) -> Path:
        p = data_root(self.system_folders) / self.kind / self.name
        p.mkdir(parents=True, exist_ok=True)
        return p

    @property
    def log_dir(self) -> Path:
        p = state_root(self.system_folders) / self.kind / self.name / "log"
        p.mkdir(parents=True, exist_ok=True)
        return p


class NodeContext(AppContext):
    kind = "node"

    @property
    def databases(self) -> list[dict[str, Any]]:
        return self.config.get("databases", []) or []

    @property
    def api_url(self) -> str:
        return self.config["api_url"]

    @property
    def api_key(self) -> str:
        return self.config["api_key"]

    @property
    def private_key_path(self) -> Path:
        enc = self.config.get("encryption", {}) or {}
        return Path(enc.get("private_key", self.data_dir / "private_key.pem"))


class ServerContext(AppContext):
    kind = "server"

    DEFAULT_PORT = 7601

    @property
    def port(self) -> int:
        return int(self.config.get("port", self.DEFAULT_PORT))

    @property
    def uri(self) -> str:
        """Database URI; default is a sqlite file in the instance data dir."""
        return self.config.get("uri", f"sqlite:///{self.data_dir}/server.db")


class StoreContext(AppContext):
    kind = "store"

    DEFAULT_PORT = 7602

    @property
    def port(self) -> int:
        return int(self.config.get("port", self.DEFAULT_PORT))

    @property
    def uri(self) -> str:
        return self.config.get("uri", f"sqlite:///{self.data_dir}/store.db")
