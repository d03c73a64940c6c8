"""Federation configuration: YAML configs + contexts.

Parity: vantage6-common context/configuration_manager (SURVEY.md §2 item 22) —
the reference locates YAML node/server configs in well-known dirs, validates
them against a schema, and exposes them through ``NodeContext``/
``ServerContext``. Here one *federation* YAML describes the whole simulated
network (server-side entities + every station), because stations are mesh
slices of one pod rather than daemons on separate machines.

The port's copy of ``vantage6_tpu/core/config.py``. PyYAML is imported
only by ``load``/``save``: ``from_dict``/``to_dict``/``validate`` need
nothing beyond the standard library. As in the reference,
``devices_per_station`` is checked where a mesh is built: a
``FederationMesh`` over a process group (``core.distributed``) takes a
station spanning that many ranks, with its own subgroup, and refuses a
value its world size cannot hold; a ``Federation`` runs every station in
one process and refuses anything but 1.

Example::

    federation:
      name: demo
      encrypted: false
      devices_per_station: 1
    stations:
      - name: station_a
        organization: org_a
        api_key: "..."           # optional; parity with node api_key auth
        databases:
          - label: default
            type: csv
            uri: data/a.csv
        policies:
          allowed_algorithms: ["*"]
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any


class ConfigurationError(Exception):
    pass


@dataclasses.dataclass
class DatabaseConfig:
    """One data source at a station (reference: node config `databases:`)."""

    label: str
    type: str = "csv"  # csv | parquet | excel | sql | sparql | omop | array | session
    uri: str = ""
    options: dict[str, Any] = dataclasses.field(default_factory=dict)

    _KNOWN_TYPES = {
        "csv", "parquet", "excel", "sql", "sparql", "omop", "array",
        "session",  # a session-store dataframe (node-resolved local path)
    }

    def validate(self) -> None:
        if not self.label:
            raise ConfigurationError("database needs a label")
        if self.type not in self._KNOWN_TYPES:
            raise ConfigurationError(
                f"unknown database type {self.type!r}; expected one of "
                f"{sorted(self._KNOWN_TYPES)}"
            )


@dataclasses.dataclass
class StationConfig:
    """Config of one data station (reference: one node YAML)."""

    name: str
    organization: str = ""
    api_key: str = ""
    databases: list[DatabaseConfig] = dataclasses.field(default_factory=list)
    policies: dict[str, Any] = dataclasses.field(default_factory=dict)

    def validate(self) -> None:
        if not self.name:
            raise ConfigurationError("station needs a name")
        labels = [d.label for d in self.databases]
        if len(labels) != len(set(labels)):
            raise ConfigurationError(f"duplicate database labels in {self.name}")
        for d in self.databases:
            d.validate()

    def database(self, label: str = "default") -> DatabaseConfig:
        for d in self.databases:
            if d.label == label:
                return d
        raise KeyError(f"station {self.name} has no database {label!r}")


@dataclasses.dataclass
class FederationConfig:
    """The whole federation: global options + all stations."""

    name: str = "federation"
    encrypted: bool = False
    devices_per_station: int = 1
    # Host-path station executor pool (runtime.executor.StationExecutor):
    #   None -> default min(n_stations, os.cpu_count()) worker threads;
    #   0    -> fully synchronous dispatch (the deterministic-debug escape
    #           hatch — today's sequential semantics, no threads at all);
    #   N>0  -> exactly N worker threads (per-station serialization holds
    #           at any size).
    executor_workers: int | None = None
    # Gradient compression of host-plane delta exchanges (a
    # fed.compression.CompressorSpec, or None): when set, algorithm code
    # can route update payloads through client.compress_update /
    # client.decompress_update and the federation keeps per-station
    # error-feedback accumulators between rounds (docs/compression.md).
    # Typed Any so core stays import-light; validate() duck-checks it.
    compressor: Any = None
    # Learning-plane recording of device-mode aggregations
    # (docs/observability.md "learning plane"): every aggregate_stacked
    # records per-station update stats into the process LEARNING
    # registry. The stats pass pulls the [S, N] stacked result to host
    # once per aggregation — set False where that transfer matters
    # (large models on a real pod), same stance as
    # FedAvgSpec.learning_stats.
    learning_stats: bool = True
    # Autopilot remediation engine (runtime.autopilot —
    # docs/OPERATOR_GUIDE.md "autopilot"): when `enabled`, the Federation
    # attaches an Autopilot to the process watchdog with itself as the
    # actuator (mask / selection-weight / admission capabilities). Keys:
    #   enabled: bool (default False — opt in per federation)
    #   dry_run: bool (log + count decisions, touch nothing)
    #   disable: [rule names] (turn individual policies off)
    #   straggler_weight: float (shrunk selection weight, default 0.25)
    autopilot: dict[str, Any] | None = None
    stations: list[StationConfig] = dataclasses.field(default_factory=list)
    server: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_stations(self) -> int:
        return len(self.stations)

    def resolved_executor_workers(self) -> int:
        """The effective pool size (0 = synchronous)."""
        if self.executor_workers is not None:
            return self.executor_workers
        return min(self.n_stations, os.cpu_count() or 1)

    def validate(self) -> None:
        if not self.stations:
            raise ConfigurationError("federation needs at least one station")
        if self.executor_workers is not None and self.executor_workers < 0:
            raise ConfigurationError(
                "executor_workers must be >= 0 (0 = synchronous dispatch)"
            )
        if self.compressor is not None:
            validate = getattr(self.compressor, "validate", None)
            if not callable(validate):
                raise ConfigurationError(
                    "compressor must be a CompressorSpec "
                    "(vantage6_tpu_torch.fed.compression) or None"
                )
            try:
                validate()
            except ValueError as e:
                raise ConfigurationError(f"bad compressor: {e}") from e
        if self.autopilot is not None:
            if not isinstance(self.autopilot, dict):
                raise ConfigurationError(
                    "federation.autopilot must be a mapping "
                    "(enabled/dry_run/disable/straggler_weight), got "
                    f"{self.autopilot!r}"
                )
            allowed = {"enabled", "dry_run", "disable", "straggler_weight"}
            unknown = set(self.autopilot) - allowed
            if unknown:
                raise ConfigurationError(
                    "federation.autopilot: unknown key(s) "
                    f"{sorted(unknown)} (expected {sorted(allowed)})"
                )
        names = [s.name for s in self.stations]
        if len(names) != len(set(names)):
            raise ConfigurationError("duplicate station names")
        for s in self.stations:
            s.validate()

    # ---------------------------------------------------------------- yaml io
    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "FederationConfig":
        fed = raw.get("federation", {}) or {}
        stations = []
        for s in raw.get("stations", []) or []:
            dbs = [
                DatabaseConfig(
                    label=d.get("label", "default"),
                    type=d.get("type", "csv"),
                    uri=_interp_env(str(d.get("uri", ""))),
                    options=d.get("options", {}) or {},
                )
                for d in (s.get("databases", []) or [])
            ]
            stations.append(
                StationConfig(
                    name=s.get("name", ""),
                    organization=s.get("organization", ""),
                    api_key=s.get("api_key", ""),
                    databases=dbs,
                    policies=s.get("policies", {}) or {},
                )
            )
        workers = fed.get("executor_workers")
        compressor = None
        comp_raw = fed.get("compression")
        if comp_raw:
            if not isinstance(comp_raw, dict):
                raise ConfigurationError(
                    "federation.compression must be a mapping "
                    "(topk_ratio/int8/chunk/error_feedback), got "
                    f"{comp_raw!r}"
                )
            # unknown keys fail LOUD: a typo ('topk:' — the V6T_COMPRESS
            # spelling — instead of 'topk_ratio:') would otherwise build
            # an identity spec and silently disable compression
            allowed = {"topk_ratio", "int8", "chunk", "error_feedback"}
            unknown = set(comp_raw) - allowed
            if unknown:
                raise ConfigurationError(
                    "federation.compression: unknown key(s) "
                    f"{sorted(unknown)} (expected {sorted(allowed)})"
                )
            # lazy import: core stays free of the fed/torch dependency unless
            # a config actually turns compression on
            from vantage6_tpu_torch.fed.compression import CompressorSpec

            ratio = comp_raw.get("topk_ratio")
            compressor = CompressorSpec(
                topk_ratio=None if ratio is None else float(ratio),
                int8=bool(comp_raw.get("int8", False)),
                chunk=int(comp_raw.get("chunk", 256)),
                error_feedback=bool(comp_raw.get("error_feedback", True)),
            )
        cfg = cls(
            name=fed.get("name", "federation"),
            encrypted=bool(fed.get("encrypted", False)),
            devices_per_station=int(fed.get("devices_per_station", 1)),
            executor_workers=None if workers is None else int(workers),
            compressor=compressor,
            autopilot=fed.get("autopilot"),
            stations=stations,
            server=raw.get("server", {}) or {},
        )
        cfg.validate()
        return cfg

    @classmethod
    def load(cls, path: str | Path) -> "FederationConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f)
        if not isinstance(raw, dict):
            raise ConfigurationError(f"{path}: not a mapping")
        return cls.from_dict(raw)

    def to_dict(self) -> dict[str, Any]:
        return {
            "federation": {
                "name": self.name,
                "encrypted": self.encrypted,
                "devices_per_station": self.devices_per_station,
                "executor_workers": self.executor_workers,
                **(
                    {"autopilot": self.autopilot}
                    if self.autopilot is not None else {}
                ),
            },
            "server": self.server,
            "stations": [
                {
                    "name": s.name,
                    "organization": s.organization,
                    "api_key": s.api_key,
                    "databases": [
                        {
                            "label": d.label,
                            "type": d.type,
                            "uri": d.uri,
                            "options": d.options,
                        }
                        for d in s.databases
                    ],
                    "policies": s.policies,
                }
                for s in self.stations
            ],
        }

    def save(self, path: str | Path) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


def _interp_env(value: str) -> str:
    """`${VAR}` env interpolation in URIs (reference config does the same)."""
    return os.path.expandvars(value)


def config_root(system_folders: bool = False) -> Path:
    """The root of the per-user (or system) config dirs, XDG-style."""
    if system_folders:
        return Path("/etc/vantage6_tpu")
    return Path(os.environ.get("XDG_CONFIG_HOME",
                               os.path.expanduser("~/.config"))
                ) / "vantage6_tpu"


def default_config_dir() -> Path:
    """Well-known per-user config dir (reference uses appdirs)."""
    return config_root()


def demo_federation(n_stations: int = 2, name: str = "dev") -> FederationConfig:
    """Generate a demo federation config (reference: `v6 dev create-demo-network`)."""
    return FederationConfig(
        name=name,
        stations=[
            StationConfig(
                name=f"station_{i}",
                organization=f"org_{i}",
                databases=[DatabaseConfig(label="default", type="array")],
            )
            for i in range(n_stations)
        ],
    )
