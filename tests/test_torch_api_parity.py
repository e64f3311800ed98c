"""The JAX package's public API against the port's, walked on the CPU.

For every public module of a JAX subpackage, every public function and
class it defines or exports (`__all__`) and every public method of those
classes, the port has the counterpart at the same path, and it accepts
every JAX parameter name. JAX's positional parameters keep their places in
the port up to the first one that the allow-list excuses, so that a call
written for the JAX package binds the same arguments in the port.

The exceptions are `ALLOW`, one line of reason each. A key is the path
below the package (`mesh.ops.distance_to_surface`), with a parameter in
brackets (`mesh.ops.distance_to_surface(force_xla)`). An entry that names
no gap any more fails the test, so the list cannot go stale.
"""

import importlib
import inspect
import pkgutil

import pytest

GENERATOR = "PyTorch idiom: JAX's PRNG key is a torch.Generator (`generator`)"
HOLDS_PARAMS = "the torch module holds its parameters; JAX passes them in"
FORWARD = "JAX's functional apply is the module's forward; `apply` is nn.Module's own method"

ALLOW = {
    # modules
    "native.libnative": "the built C++ library, not a Python module (the port builds native.cpp into build/native/)",
    "ops.bucketing": "power-of-two buckets exist so XLA compiles once a bucket; torch needs no padding to buckets",
    "ops.pallas_conv": "the Pallas conv kernel, replaced by the Hopper kernels in csrc/ (ops/cuda_conv.py)",
    "ops.pallas_kernels": "the Pallas distance kernel, replaced by csrc/point_triangle.cu (ops/cuda_kernels.py)",
    "utils.compile_cache": "XLA's persistent cache; nvcc builds are cached by content hash in build/kernels/",
    # names
    "enable_compilation_cache": "XLA's persistent cache; nvcc builds are cached by content hash in build/kernels/",
    "models.unet3d.zstack_supported": "routes a conv to the Pallas kernel; the port routes by ops.cuda_conv.conv3d_route",
    "models.unet3d.UNet3D.apply": FORWARD,
    "models.cascade.CascadedUNet.apply": FORWARD,
    "utils.checkpoint.save_checkpoint_orbax": "orbax is installed on neither machine; the npz format is read by both",
    "utils.checkpoint.load_checkpoint_orbax": "orbax is installed on neither machine; the npz format is read by both",
    # parameters
    "engine.training.train_segmentation(key)": GENERATOR,
    "models.cascade.CascadedUNet.init(key)": GENERATOR,
    "models.gradicon.GradICON.init(key)": GENERATOR,
    "models.unet3d.UNet3D.init(key)": GENERATOR,
    "utils.checkpoint.initialize_model(key)": GENERATOR,
    "utils.checkpoint.convert_torch_unet_state_dict(rng_key)": GENERATOR,
    "models.unet3d.make_threshold_params(key)": "deleted unread by JAX (unet3d.py:306): the weights draw nothing",
    "models.unet3d.UNet3D.init(dtype)": "the module's parameters are f32 masters; the compute dtype is the constructor's",
    "models.unet3d.UNet3D(precision)": "an XLA matmul-precision switch; the port's convs are its own kernels",
    "models.unet3d.UNet3D(conv_impl)": "chooses XLA or Pallas; the port routes by ops.cuda_conv.conv3d_route",
    "models.unet3d.conv3d(p)": "the port's functional conv takes the kernel and bias tensors",
    "models.unet3d.conv3d(padding)": "the port's convs are SAME, the only padding the UNet uses",
    "models.unet3d.conv3d(precision)": "an XLA matmul-precision switch",
    "models.unet3d.upconv2x(p)": "the port's upconv takes the block that holds its parameters",
    "models.unet3d.upconv2x(precision)": "an XLA matmul-precision switch",
    "models.cascade.auto_context_step(params)": HOLDS_PARAMS,
    "models.cascade.CascadedUNet.trainable_params(params_list)": HOLDS_PARAMS,
    "models.gradicon.GradICON.forward_map(params_list)": HOLDS_PARAMS,
    "models.gradicon.GradICON.both_maps(params_list)": HOLDS_PARAMS,
    "models.gradicon.GradICON.loss(params_list)": HOLDS_PARAMS,
    "mesh.ops.distance_to_surface(point_chunk)": "chunks JAX's XLA fallback; the port always runs its distance kernel",
    "mesh.ops.distance_to_surface(force_xla)": "skips the Pallas kernel; the port has no XLA fallback",
    "mesh.ops.distance_to_surface_async(point_chunk)": "chunks JAX's XLA fallback; the port always runs its kernel",
    "mesh.ops.distance_to_surface_async(force_xla)": "skips the Pallas kernel; the port has no XLA fallback",
    "mesh.ops.smooth_mesh_groups(sharding)": "a JAX placement; each rank smooths its own knees (parallel/sharding.py)",
    "mesh.processing.get_thickness_meshes(smooth_sharding)": "a JAX placement; a rank runs its own knees (parallel/sharding.py)",
    "mesh.processing.get_thickness_meshes(distance_devices)": "a JAX placement; a rank runs its own knees (parallel/sharding.py)",
    "mesh.processing.get_thickness_meshes(mc_devices)": "a JAX placement; a rank runs its own knees (parallel/sharding.py)",
    "mesh.marching.marching_tetrahedra(device_emission)": "the port always emits the triangles on the volume's device",
}

# the JAX package's subpackages; "" is its top-level package and modules
SUBPACKAGES = ("", "core", "engine", "mesh", "models", "native", "ops", "parallel", "utils")


def _jax_modules(sub: str):
    """Relative names of the public modules under `sub` ("" for the root's
    own modules), the subpackage itself first."""
    pkg = importlib.import_module("oai_analysis_2_tpu" + (f".{sub}" if sub else ""))
    if not sub:
        return [""] + [m.name for m in pkgutil.iter_modules(pkg.__path__) if not m.ispkg]
    found = pkgutil.walk_packages(pkg.__path__, f"{sub}.")
    return [sub] + [m.name for m in found if not any(p.startswith("_") for p in m.name.split("."))]


def _module(package: str, rel: str):
    return importlib.import_module(package + (f".{rel}" if rel else ""))


def _public(mod):
    """(name, object, defined here) of the functions and classes `mod`
    defines, and of the names in its `__all__`."""
    names = set(getattr(mod, "__all__", ()))
    names |= {n for n, v in vars(mod).items() if not n.startswith("_") and callable(v)}
    out = []
    for n in sorted(names - {"__version__"}):
        v = getattr(mod, n)
        here = getattr(v, "__module__", None) == mod.__name__
        if here or n in getattr(mod, "__all__", ()):
            out.append((n, v, here))
    return out


def _methods(cls):
    for name, v in vars(cls).items():
        if name.startswith("_") or isinstance(v, property):
            continue
        if callable(v) or isinstance(v, (staticmethod, classmethod)):
            yield name


def _positional(params):
    return [n for n, p in params.items() if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _signature_gaps(key: str, jobj, tobj, used: set) -> list:
    try:
        jparams = inspect.signature(jobj).parameters
        tparams = inspect.signature(tobj).parameters
    except (TypeError, ValueError):
        return []
    gaps = []
    for name, p in jparams.items():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) or name in tparams:
            continue
        if f"{key}({name})" in ALLOW:
            used.add(f"{key}({name})")
        else:
            gaps.append(f"{key}: no parameter {name!r}")
    tpos = _positional(tparams)
    for i, name in enumerate(_positional(jparams)):
        if f"{key}({name})" in ALLOW:
            break  # later arguments of a JAX call go through the excused one's place
        if i >= len(tpos) or tpos[i] != name:
            gaps.append(f"{key}: JAX's positional parameter {i} is {name!r}, the port's "
                        f"{tpos[i] if i < len(tpos) else None!r}")
            break
    return gaps


def _walk(sub: str):
    """(gaps, allow-list keys used) of one JAX subpackage against the port."""
    gaps, used = [], set()
    for rel in _jax_modules(sub):
        if rel in ALLOW:
            used.add(rel)
            continue
        jmod = _module("oai_analysis_2_tpu", rel)
        try:
            tmod = _module("oai_analysis_2_tpu_torch", rel)
        except ImportError as e:
            gaps.append(f"{rel}: no port module ({e})")
            continue
        for name, jobj, here in _public(jmod):
            key = f"{rel}.{name}" if rel else name
            if key in ALLOW:
                used.add(key)
                continue
            tobj = getattr(tmod, name, None)
            if tobj is None:
                gaps.append(f"{key}: missing")
                continue
            if not here:  # a re-export: its signature is checked where it is defined
                continue
            gaps += _signature_gaps(key, jobj, tobj, used)
            if not inspect.isclass(jobj):
                continue
            for meth in _methods(jobj):
                mkey = f"{key}.{meth}"
                if mkey in ALLOW:
                    used.add(mkey)
                    continue
                if not hasattr(tobj, meth):
                    gaps.append(f"{mkey}: missing")
                    continue
                gaps += _signature_gaps(mkey, getattr(jobj, meth), getattr(tobj, meth), used)
    return gaps, used


def _in_subpackage(key: str, sub: str) -> bool:
    path = key.split("(")[0]
    head = path.split(".")[0]
    if not sub:  # the root: its own names and its plain modules
        return head not in SUBPACKAGES
    return head == sub


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "root" for s in SUBPACKAGES])
def test_port_has_the_jax_api(sub):
    """Every public module, function, class, method and parameter name of
    the JAX subpackage has its counterpart in the port, or an allow-list
    entry; and every allow-list entry of the subpackage still names a gap."""
    gaps, used = _walk(sub)
    assert not gaps, "\n".join(gaps)
    stale = sorted(k for k in ALLOW if _in_subpackage(k, sub) and k not in used)
    assert not stale, f"allow-list entries that name no gap: {stale}"


def test_allow_list_reasons():
    """One line of reason each, and the gaps this audit closed stay out."""
    for key, reason in ALLOW.items():
        assert reason.strip() and "\n" not in reason, key
    closed = {"utils.checkpoint.save_checkpoint", "engine.segmenter.Segmenter3DInPatchClassWise.volume_fn",
              "mesh.ops.distance_to_surface_async", "models.unet3d.make_threshold_params(model)",
              "mesh.projection.project_thickness(embedded)", "ops.clustering.kmeans(backend)",
              "ops.clustering.kmeans_many(backend)", "utils.profiling.StageTimer.stage(sync)",
              *(f"utils.checkpoint.save_checkpoint({p})" for p in ("is_best", "path", "prefix", "name"))}
    assert not closed & set(ALLOW)
