"""The port's config tree (tpuslam_torch/config.py) against the reference's:
same dataclasses, fields, defaults, validation and JSON round trip."""

import dataclasses
import json

import pytest

import tpuslam.config as rc
import tpuslam_torch.config as pc
from tpuslam_torch.interop import config_from_reference

DATACLASSES = ["ICPConfig", "VoxelConfig", "KeyframeConfig",
               "PoseGraphConfig", "SLAMConfig"]


@pytest.mark.parametrize("name", DATACLASSES)
def test_fields_and_defaults_match(name):
    ref, port = getattr(rc, name), getattr(pc, name)
    rf = {f.name: f for f in dataclasses.fields(ref)}
    pf = {f.name: f for f in dataclasses.fields(port)}
    assert list(rf) == list(pf)
    for k in rf:
        assert rf[k].type == pf[k].type, k
    r_default, p_default = ref(), port()
    assert dataclasses.asdict(r_default) == dataclasses.asdict(p_default)
    assert ref.__dataclass_params__.frozen and port.__dataclass_params__.frozen


def test_intrinsics_match():
    assert rc.Intrinsics._fields == pc.Intrinsics._fields
    for ctor in ("tum_fr1", "tum_fr2", "tum_fr3", "tum_default"):
        assert getattr(rc.Intrinsics, ctor)() == getattr(pc.Intrinsics, ctor)()
    K = rc.Intrinsics(525.0, 525.0, 319.5, 239.5)
    for f in (0.5, 0.25, 0.125):
        assert tuple(K.scaled(f)) == tuple(pc.Intrinsics(*K).scaled(f))


PARTIAL_JSON = json.dumps({
    "icp": {"inner_steps": 1, "packed_dtype": "float32",
            "iters_per_level": [10, 6, 4], "tol_delta_per_level": None},
    "keyframe": {"max_translation": 0.05},
    "cv_damping": 0.25,
    "height": 240, "width": 320,
})


@pytest.mark.parametrize("text", [PARTIAL_JSON, rc.SLAMConfig().to_json()])
def test_json_loads_into_both(text):
    r = rc.SLAMConfig.from_json(text)
    p = pc.SLAMConfig.from_json(text)
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    assert r.to_json() == p.to_json()
    assert isinstance(p.icp.iters_per_level, tuple)


def test_config_from_reference():
    r = rc.SLAMConfig.from_json(PARTIAL_JSON)
    p = config_from_reference(r)
    assert isinstance(p, pc.SLAMConfig)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)


@pytest.mark.parametrize("bad", [
    {"cv_damping": 0.8},
    {"depth_scale": 0.0},
    {"icp": {"finest_subsample": 3}},
    {"icp": {"pyramid_levels": 7}},
])
def test_validate_rejects_the_same(bad):
    text = json.dumps(bad)
    with pytest.raises(ValueError) as er:
        rc.SLAMConfig.from_json(text).validate()
    with pytest.raises(ValueError) as ep:
        pc.SLAMConfig.from_json(text).validate()
    assert str(er.value) == str(ep.value)
