"""The port's public names and CLI flags held complete against the JAX
package's, and the port's tensors never written through ``.data``.

Host only: every check parses source files with ``ast``; neither package is
imported, so the file runs in well under a second.

* Names.  Every public top-level function, class and assigned name of every
  module of ``brushstroke_engine_tpu/`` is bound in the port file at the same
  path (defined there, or imported there from the port module that defines
  it), or is listed in ``RENAMED`` with a target that exists, or in
  ``LEFT_OUT`` with its reason.  ``FILE_MAP`` gives the port file of the
  two Pallas modules.  No entry of the tables is stale: a ``RENAMED`` or
  ``LEFT_OUT`` name is a JAX public name that its own port path lacks.
* Flags.  Every ``scripts/*.py`` is either ported (``SCRIPT_TOOLS``: the
  JAX script and its port tool) or not (``NOT_PORTED``, with the reason).
  Each flag of a ported script, and of the JAX server, is a flag of its
  port tool; a port tool adds only ``PORT_ONLY_FLAGS``.
* ``.data``.  No statement of the port writes through ``.data``: the int8
  weight cache (``ops/quant.py:site_weight``) keys a packed weight on the
  parameter's ``_version`` and storage, which such a write moves neither of.
"""

import ast
import functools
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "brushstroke_engine_tpu"
PORT_PKG = "brushstroke_engine_torch"

# JAX module -> the port module that holds its counterparts.
FILE_MAP = {
    "ops/pallas_fir": "ops/fir_epilogue",
    "ops/pallas_warp": "ops/warp",
}

# "jax_module:name" -> "port_module:name".
RENAMED = {
    "flagship:flagship_bundle": "flagship:flagship_trees",
    "flagship:flagship_discriminator_config": "flagship:flagship_train_config",
    "models/discriminator:discriminator_init":
        "utils/checkpoint:init_native_params",
    "models/generator:generator_init": "utils/checkpoint:init_native_params",
    "models/geo_encoder:geo_encoder_init":
        "utils/checkpoint:init_encoder_trees",
    "models/mapping:mapping_init": "utils/checkpoint:init_native_params",
    "models/synthesis:synthesis_init": "utils/checkpoint:init_native_params",
    "models/synthesis:color_mapping_init":
        "utils/checkpoint:color_mapping_init",
    "models/synthesis:to_canvas_stroke_init":
        "utils/checkpoint:to_canvas_stroke_init",
    "ops/pallas_fir:fir4_epilogue_reference":
        "ops/fir_epilogue:fir4_epilogue_plain",
    "ops/pallas_warp:affine_warp_twopass_pallas":
        "ops/warp:affine_warp_twopass",
    "ui/server:RenderBatcher": "ui/core:RenderBatcher",
    "ui/server:DeviceRenderBatcher": "ui/core:DeviceRenderBatcher",
    "ui/server:generate_z_file": "ui/core:generate_z_file",
    "ui/server:warmup_engine": "ui/core:warmup_engine",
    "utils/util:commit_to_default_device": "utils/util:tree_to",
}

_NO_SWITCH = ("the Pallas kernel's opt-in switch: the port's hand kernel ({}) "
              "runs on every CUDA tensor, with no switch and no fallback")
# "jax_module:name" -> why the port has no counterpart.
LEFT_OUT = {
    "ops/pallas_fir:set_pallas_fir_enabled":
        _NO_SWITCH.format("csrc/fir4_epilogue.cu"),
    "ops/pallas_fir:pallas_fir_enabled":
        _NO_SWITCH.format("csrc/fir4_epilogue.cu"),
    "ops/pallas_warp:set_pallas_warp_enabled":
        _NO_SWITCH.format("csrc/warp_twopass.cu"),
    "ops/pallas_warp:pallas_warp_enabled":
        _NO_SWITCH.format("csrc/warp_twopass.cu"),
    "ops/precision:conv_precision":
        "a jax.lax.Precision per dtype; the port's set_precision_mode "
        "expresses the same choice as torch's TF32 switches",
    "models/layers:fc_init":
        "a per-layer jax.random initialiser; the port draws every layer "
        "from numpy inside utils/checkpoint.py's initialisers",
    "models/layers:conv_layer_init":
        "a per-layer jax.random initialiser; the port draws every layer "
        "from numpy inside utils/checkpoint.py's initialisers",
    "engine/device_canvas:render_stroke_packed":
        "one packed float32 upload per request, for a device behind a "
        "network tunnel; the port's render_stroke_step takes the patch and "
        "the position as they are",
    "utils/util:tree_on_stale_backend":
        "finds JAX arrays of a backend torn down by clear_backends; a torch "
        "tensor has no backend to go stale",
}

# JAX script -> the port tool that takes its flags (paths from the repo).
SCRIPT_TOOLS = {f"scripts/{s}.py": f"{PORT_PKG}/tools/{t}.py" for s, t in (
    ("calc_metrics", "calc_metrics"),
    ("clip_search_main", "clip_search_main"),
    ("convert_checkpoint", "convert_checkpoint"),
    ("create_splines", "create_splines"),
    ("dataset_tool", "dataset_tool"),
    ("diagnose_color_control", "diagnose_color_control"),
    ("drive_brush_server", "drive_brush_server"),
    ("fetch_and_verify_weights", "fetch_and_verify_weights"),
    ("fid_from_images", "fid_from_images"),
    ("get_ws_main", "get_ws_main"),
    ("make_synthetic_media", "make_synthetic_media"),
    ("make_synthetic_styles", "make_synthetic_styles"),
    ("metric_main", "metric_main"),
    ("opt_clarity_main", "opt_clarity_main"),
    ("paint_image_main", "paint_image"),
    ("patch_augment", "patch_augment"),
    ("plot_colors", "plot_colors"),
    ("prep_geom_data", "prep_geom_data"),
    ("project_main", "project_main"),
    ("reformat_triband_data_main", "reformat_triband_data_main"),
    ("seed_expand", "seed_expand"),
    ("train_main", "train"),
    ("train_stroke_autoencoder", "train_autoencoder"),
    ("visualize_main", "visualize_main"),
    ("visualize_pca_main", "visualize_pca_main"),
    ("visualize_stitching_main", "visualize_stitching"),
)}
SERVER = (f"{JAX_PKG}/ui/server.py", f"{PORT_PKG}/ui/server.py")

_TPU_TIMING = ("times JAX programs on the TPU; the port's yardsticks are "
               "chip_smoke.py, tools/profile_*.py, tools/bench_serve.py and "
               "tools/bench_int8.py")
NOT_PORTED = {
    "scripts/bench_canvas.py": _TPU_TIMING,
    "scripts/bench_latency.py": _TPU_TIMING,
    "scripts/bench_projection.py": _TPU_TIMING,
    "scripts/bench_ref_cpu.py":
        "times the reference engine against the JAX package on the CPU",
    "scripts/bench_train.py": _TPU_TIMING,
    "scripts/bench_ws_slo.py": _TPU_TIMING,
    "scripts/microbench_int8.py":
        "int8 against bf16 convs on XLA:TPU's MXU, the evidence for the "
        "JAX package's int8 gate",
    "scripts/microbench_render_parts.py": _TPU_TIMING,
    "scripts/microbench_s2d.py":
        "a space-to-depth A/B of one strided conv on the TPU's MXU",
    "scripts/microbench_train_parts.py": _TPU_TIMING,
    "scripts/phase_flops.py":
        "XLA's cost analysis of each training phase; the port has no "
        "compiler cost model",
    "scripts/profile_train_phases.py": _TPU_TIMING,
    "scripts/repro_b128_compile_pathology.py":
        "reproduces an XLA:TPU compile of the generator at B = 128",
}

PORT_ONLY_FLAGS = {
    "--device": "the port's entry points run on the card unless asked for "
                "the CPU",
    "--channel_base": "the JAX CLI builds G and D at channel_base 16384, "
                      "which StyleGAN2 config-f (32768) cannot use",
}


# ---------------------------------------------------------------------------
# Reading modules
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _parse(path):
    with open(os.path.join(REPO, path)) as f:
        return ast.parse(f.read(), filename=path)


def _top_level(body):
    """Top-level statements, with those under a module-level ``if`` or
    ``try`` (import guards) counted as top level."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body + node.orelse + node.finalbody
                                  + [s for h in node.handlers
                                     for s in h.body])
        else:
            yield node


def _modules(pkg):
    """Module paths (``ops/conv``) of a package's ``.py`` files."""
    root = os.path.join(REPO, pkg)
    return sorted(os.path.relpath(p, root)[:-3] for p in glob.glob(
        os.path.join(root, "**", "*.py"), recursive=True))


@functools.lru_cache(maxsize=None)
def _bindings(pkg, module):
    """(names defined at the top level, {name: port module it is imported
    from}) of ``pkg/module.py``."""
    defined, imported = set(), {}
    for node in _top_level(_parse(f"{pkg}/{module}.py").body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                defined |= {n.id for n in ast.walk(t)
                            if isinstance(n, ast.Name)}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and (node.module or "").startswith(PORT_PKG + "."):
            src = node.module[len(PORT_PKG) + 1:].replace(".", "/")
            for a in node.names:
                imported[a.asname or a.name] = (src, a.name)
    return defined, imported


def _public(names):
    return {n for n in names if not n.startswith("_")}


def _port_has(module, name, depth=0):
    """True when ``name`` is bound at the top of the port's ``module``:
    defined there, or imported there from the port module defining it."""
    if depth > 4 or not os.path.isfile(
            os.path.join(REPO, PORT_PKG, module + ".py")):
        return False
    defined, imported = _bindings(PORT_PKG, module)
    if name in defined:
        return True
    if name in imported:
        src, orig = imported[name]
        if os.path.isfile(os.path.join(REPO, PORT_PKG, src + ".py")):
            return _port_has(src, orig, depth + 1)
        return _port_has(src + "/__init__", orig, depth + 1)
    return False


def _split(key):
    module, _, name = key.partition(":")
    return module, name


@functools.lru_cache(maxsize=None)
def _missing_names():
    """JAX public names with no counterpart at their port path."""
    out = []
    for module in _modules(JAX_PKG):
        defined, _ = _bindings(JAX_PKG, module)
        port = FILE_MAP.get(module, module)
        out += [f"{module}:{n}" for n in sorted(_public(defined))
                if not _port_has(port, n)]
    return out


# ---------------------------------------------------------------------------
# Names
# ---------------------------------------------------------------------------

def test_every_jax_public_name_has_a_port_counterpart():
    unaccounted = [k for k in _missing_names()
                   if k not in RENAMED and k not in LEFT_OUT]
    assert not unaccounted, (
        "JAX public names with no port counterpart at their path, and in "
        f"neither RENAMED nor LEFT_OUT: {unaccounted}")


@pytest.mark.parametrize("key", sorted(RENAMED))
def test_renamed_target_exists(key):
    module, name = _split(RENAMED[key])
    assert _port_has(module, name), \
        f"{key} -> {RENAMED[key]}: the target is not in the port"


def test_tables_name_only_what_is_missing():
    """Each RENAMED / LEFT_OUT key is a JAX public name, and one the port
    lacks at its own path (else the entry is stale); no name is in both."""
    missing = set(_missing_names())
    assert not set(RENAMED) & set(LEFT_OUT)
    for key in list(RENAMED) + list(LEFT_OUT):
        module, name = _split(key)
        defined, _ = _bindings(JAX_PKG, module)
        assert name in _public(defined), f"{key} is no JAX public name"
        assert key in missing, f"{key} is ported at its path: drop the entry"
    for key, why in LEFT_OUT.items():
        assert why.strip() and "\n" not in why, key


def test_every_jax_module_has_a_port_file():
    for module in _modules(JAX_PKG):
        port = FILE_MAP.get(module, module)
        assert os.path.isfile(os.path.join(REPO, PORT_PKG, port + ".py")), \
            f"{JAX_PKG}/{module}.py has no port file {PORT_PKG}/{port}.py"


# ---------------------------------------------------------------------------
# CLI flags
# ---------------------------------------------------------------------------

def _literal(node, consts):
    if isinstance(node, ast.Name):
        return consts[node.id]
    return ast.literal_eval(node)


def _flag_strings(node, env):
    """The option strings of an ``add_argument`` call; an f-string flag is
    expanded over the loop variables in ``env``."""
    out = []
    for a in node.args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            out.append(a.value)
        elif isinstance(a, ast.JoinedStr):
            parts = []
            for v in a.values:
                if isinstance(v, ast.Constant):
                    parts.append(str(v.value))
                elif isinstance(v, ast.FormattedValue) \
                        and isinstance(v.value, ast.Name) \
                        and v.value.id in env:
                    parts.append(str(env[v.value.id]))
                else:
                    raise AssertionError(
                        f"unresolved flag {ast.unparse(a)}")
            out.append("".join(parts))
        else:
            raise AssertionError(f"unresolved flag {ast.unparse(a)}")
    return [s for s in out if s.startswith("-")]


def cli_flags(path):
    """Every ``--flag`` a file's ``add_argument`` calls (and
    ``add_log_level_flag``) register, with flags made in a ``for`` loop
    over a literal (or a module-level constant) expanded."""
    tree = _parse(path)
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                consts[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    flags = set()

    def visit(node, envs):
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            try:
                values = list(_literal(node.iter, consts))
            except (KeyError, ValueError):
                values = None
            if values is not None:
                inner = [dict(e, **{node.target.id: v})
                         for e in envs for v in values]
                for child in node.body + node.orelse:
                    visit(child, inner)
                return
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "add_argument":
            for env in envs:
                flags.update(_flag_strings(node, env))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "add_log_level_flag":
            flags.add("--log_level")
        for child in ast.iter_child_nodes(node):
            visit(child, envs)

    visit(tree, [{}])
    return {f for f in flags if f.startswith("--")}


def test_every_script_is_ported_or_listed():
    scripts = {os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "scripts", "*.py"))}
    assert not set(SCRIPT_TOOLS) & set(NOT_PORTED)
    assert scripts == set(SCRIPT_TOOLS) | set(NOT_PORTED), (
        f"unlisted: {sorted(scripts - set(SCRIPT_TOOLS) - set(NOT_PORTED))}"
        f"; listed but absent: "
        f"{sorted(set(SCRIPT_TOOLS) | set(NOT_PORTED) - scripts)}")
    for why in NOT_PORTED.values():
        assert why.strip() and "\n" not in why


@pytest.mark.parametrize("script,tool", sorted(SCRIPT_TOOLS.items())
                         + [SERVER])
def test_port_tool_takes_every_flag_of_the_jax_cli(script, tool):
    jax_flags, port_flags = cli_flags(script), cli_flags(tool)
    assert jax_flags, f"{script}: no flags found"
    assert jax_flags <= port_flags, \
        f"{tool} lacks the flags {sorted(jax_flags - port_flags)} of {script}"
    extra = port_flags - jax_flags
    assert extra <= set(PORT_ONLY_FLAGS), \
        f"{tool} adds flags {sorted(extra - set(PORT_ONLY_FLAGS))}"


def test_flag_reader_expands_loops():
    """The reader sees through the loop that makes the installer's
    per-family flags (a literal tuple on the JAX side, a module constant
    on the port's)."""
    fams = {"--inception", "--lpips", "--vgg16", "--clip", "--clip_bpe"}
    for path in ("scripts/fetch_and_verify_weights.py",
                 f"{PORT_PKG}/tools/fetch_and_verify_weights.py"):
        assert fams <= cli_flags(path), path


# ---------------------------------------------------------------------------
# No write through .data
# ---------------------------------------------------------------------------

def _through_data(node):
    """True when ``node`` is ``<expr>.data`` or lies under it by
    subscripts and attributes (``x.data[i]``, ``x.data.real``)."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if isinstance(node, ast.Attribute) and node.attr == "data":
            return True
        node = node.value
    return False


def _is_inplace(name):
    return name.endswith("_") and not name.startswith("_")


def data_writes(path):
    """Lines of ``path`` that write through ``.data``: an assignment (plain,
    augmented or annotated) to ``x.data`` or below it, an in-place method
    called on it, ``setattr(x, "data", ...)`` or ``out=x.data``."""
    bad = []
    for node in ast.walk(_parse(path)):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, (ast.Attribute, ast.Subscript)) \
                        and _through_data(sub) \
                        and isinstance(sub.ctx, ast.Store):
                    bad.append((node.lineno, ast.unparse(node)))
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and _is_inplace(f.attr) \
                    and _through_data(f.value):
                bad.append((node.lineno, ast.unparse(node)))
            if isinstance(f, ast.Name) and f.id == "setattr" \
                    and len(node.args) >= 2 \
                    and isinstance(node.args[1], ast.Constant) \
                    and node.args[1].value == "data":
                bad.append((node.lineno, ast.unparse(node)))
            for kw in node.keywords:
                if kw.arg == "out" and _through_data(kw.value):
                    bad.append((node.lineno, ast.unparse(node)))
    return bad


def test_no_port_statement_writes_through_data():
    bad = {}
    for module in _modules(PORT_PKG):
        path = f"{PORT_PKG}/{module}.py"
        found = data_writes(path)
        if found:
            bad[path] = found
    assert not bad, f"writes through .data: {bad}"


def test_data_write_finder_sees_each_form(tmp_path):
    src = ("p.data = t\n"
           "p.data[0] = 1\n"
           "p.data += 1\n"
           "p.data.copy_(t)\n"
           "m.w.data[:, 0].zero_()\n"
           "setattr(p, 'data', t)\n"
           "torch.add(a, b, out=p.data)\n"
           "y = p.data.clone()\n"
           "y = wp.data\n"
           "q.copy_(p.data)\n")
    path = tmp_path / "probe.py"
    path.write_text(src)
    lines = [ln for ln, _ in data_writes(str(path))]
    assert lines == list(range(1, 8))
