"""Configs from flat dotted keys and ``.properties`` files (port of
``slam_constructor_tpu.utils.config``).

A config is the static dataclass an engine runs on (``EngineConfig``,
``GMappingConfig``); this module builds one from a flat string-to-value
mapping, as the reference's ``PropertiesProvider`` selects component
implementations and numeric parameters: cell model, matcher and its
parameters, an optional refine matcher, the scoring and the scan adder.

Unknown keys are ignored, as the reference ignores them. Keys that name a
field the port does not have are ignored with them: those that choose a
TPU lowering (``scoring.impl``, ``scoring.dtype``, ``beam.scatter_impl``,
``matcher.chunk`` of the brute-force matcher). ``scoring.dtype`` changes
nothing off the TPU: the reference reads it only on its matmul path, which
``impl='auto'`` takes only on a TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from ..ops import cells as cellslib
from ..ops import m3rsm as _m3rsm  # noqa: F401  (registers "m3rsm" in MATCHERS)
from ..ops import matchers as matcherslib
from ..ops import raycast, scoring

# --- flat-key config parsing ------------------------------------------------


def parse_properties(text: str) -> dict[str, str]:
    """Parse a java-style ``.properties`` text: ``key = value`` lines;
    lines starting with ``#``, ``;`` or ``//`` are comments."""
    out: dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith(("#", ";", "//")):
            continue
        if "=" in line:
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def load_properties(path: str) -> dict[str, str]:
    with open(path) as f:
        return parse_properties(f.read())


def _coerce(v: Any, like: Any) -> Any:
    """``v`` as the type of ``like`` (bool before int: a bool is an int)."""
    if isinstance(like, bool):
        return str(v).lower() in ("1", "true", "yes", "on")
    if isinstance(like, int):
        return int(v)
    if isinstance(like, float):
        return float(v)
    return v


def _fields_from(p: Mapping[str, Any], base, prefix: str, skip=()) -> dict:
    """The fields of dataclass instance ``base`` that ``p`` sets under
    ``prefix``, coerced to the type of their defaults."""
    kw = {}
    for f in dataclasses.fields(base):
        if not f.init or f.name in skip:
            continue
        key = prefix + f.name
        if key in p:
            kw[f.name] = _coerce(p[key], getattr(base, f.name))
    return kw


def _build_scoring(p: Mapping[str, Any], prefix: str = "scoring.") -> scoring.ScoringConfig:
    base = scoring.ScoringConfig()
    return dataclasses.replace(base, **_fields_from(p, base, prefix))


def _build_beam(p: Mapping[str, Any], prefix: str = "beam.") -> raycast.BeamConfig:
    base = raycast.BeamConfig()
    return dataclasses.replace(base, **_fields_from(p, base, prefix))


def _build_cell_model(p: Mapping[str, Any]):
    cls = cellslib.CELL_MODELS[p.get("cell.model", "bayes_avg")]
    return cls(**_fields_from(p, cls(), "cell."))


def _build_matcher(p: Mapping[str, Any], sc: scoring.ScoringConfig, prefix: str = "matcher"):
    kind = p.get(f"{prefix}.type", "monte_carlo")
    cfg_cls, _ = matcherslib.MATCHERS[kind]
    kw = _fields_from(p, cfg_cls(), f"{prefix}.", skip=("scoring",))
    return kind, cfg_cls(scoring=sc, **kw)


def _build_refine(p: Mapping[str, Any], sc: scoring.ScoringConfig):
    """The optional refine stage: ``refine.type`` names the second matcher
    (gradient, hill_climbing, ...), ``refine.*`` its parameters."""
    if "refine.type" not in p:
        return None, None
    return _build_matcher(p, sc, prefix="refine")


def engine_config_from(p: Mapping[str, Any]):
    """An ``EngineConfig`` from flat dotted keys."""
    from ..models.engine import EngineConfig

    sc = _build_scoring(p)
    matcher, matcher_cfg = _build_matcher(p, sc)
    refine, refine_cfg = _build_refine(p, sc)
    return EngineConfig(
        cell_model=_build_cell_model(p),
        matcher=matcher,
        matcher_cfg=matcher_cfg,
        refine_matcher=refine,
        refine_cfg=refine_cfg,
        beam=_build_beam(p),
        map_height=int(p.get("map.height", 256)),
        map_width=int(p.get("map.width", 256)),
        map_scale=float(p.get("map.scale", 0.1)),
        min_insert_prob=float(p.get("engine.min_insert_prob", 0.0)),
        use_angle_histogram=str(p.get("engine.use_angle_histogram", "false")).lower()
        in ("1", "true", "yes"),
        map_storage=str(p.get("engine.map_storage", "dense")),
        tile_block=int(p.get("engine.tile_block", 32)),
        tile_capacity=int(p.get("engine.tile_capacity", 512)),
        window_tiles=int(p.get("engine.window_tiles", 10)),
    )


def gmapping_config_from(p: Mapping[str, Any]):
    """A ``GMappingConfig`` from flat dotted keys."""
    from ..models.gmapping import GMappingConfig

    sc = _build_scoring(p)
    matcher, matcher_cfg = _build_matcher(p, sc)
    return GMappingConfig(
        n_particles=int(p.get("pf.particles", 30)),
        cell_model=_build_cell_model(p),
        matcher=matcher,
        matcher_cfg=matcher_cfg,
        beam=_build_beam(p),
        map_height=int(p.get("map.height", 256)),
        map_width=int(p.get("map.width", 256)),
        map_scale=float(p.get("map.scale", 0.1)),
        noise_xy=float(p.get("pf.noise_xy", 0.03)),
        noise_theta=float(p.get("pf.noise_theta", 0.015)),
        resample_threshold=float(p.get("pf.resample_threshold", 0.5)),
        weight_gamma=float(p.get("pf.weight_gamma", 8.0)),
        proposal=str(p.get("pf.proposal", "odom")),
        proposal_samples=int(p.get("pf.proposal_samples", 16)),
        match_window=int(p.get("pf.match_window", 0)),
        insert_window=int(p.get("pf.insert_window", 0)),
    )


# --- presets ----------------------------------------------------------------


def preset(name: str):
    """An engine factory by preset name (the reference's BASELINE
    configs[0..4]); its keyword arguments go to the engine.
    ``distributed`` (config[4]) is ``make(mesh=None, device=None, **kw) ->
    (cfg, state, step)``: a ``GMappingConfig(**kw)`` (its full width the
    defaults: 30 particles with whole 256^2 maps, 16 x 6 Monte-Carlo
    rounds) sharded over the particles of ``mesh``, by default the flat
    ``particles`` mesh of the running process group
    (``parallel.mesh.init`` first); ``state`` is this rank's particles and
    ``step(state, scan, odom_delta, draws=None, generator=None)``
    ``parallel.particles.make_sharded_step``'s."""
    from ..models import full, gmapping, tiny, viny

    if name == "tiny":
        return lambda **kw: tiny.make_engine(**kw)
    if name == "viny":
        return lambda **kw: viny.make_engine(**kw)
    if name == "gmapping":
        return lambda **kw: gmapping.GMappingEngine(**kw)
    if name == "full":
        return lambda **kw: full.FullSlamEngine(**kw)
    if name == "distributed":
        from ..parallel import mesh as meshlib
        from ..parallel import particles

        def make(mesh=None, device=None, **kw):
            cfg = gmapping.GMappingConfig(**kw)
            if mesh is None:
                mesh = meshlib.flat_mesh("particles")
            state = particles.shard_state(gmapping.init_state(cfg, device), mesh)
            return cfg, state, particles.make_sharded_step(cfg, mesh)

        return make
    raise KeyError(name)


PRESETS = ("tiny", "viny", "gmapping", "full", "distributed")
