"""The declarative serve config (ray_tpu_torch.serve.schema) and the gRPC
ingress (ray_tpu_torch.serve.grpc_proxy, serve.start_grpc) against
ray_tpu.serve's, on the CPU.

Every flow of tests/test_serve_schema.py that runs in one process runs
under both packages, each app module written for its own package: parse
and load (JSON, and YAML where PyYAML is installed), the deployment
overrides, app factories with args and kwargs, the errors for unknown fields, a
bad import path and an app's speculation or disaggregation options (each
naming the app), `apply` in thread mode serving over HTTP, a route prefix
and the root route; and, where `grpc` is installed, the generic and typed
gRPC round trips: unary, the NOT_FOUND status, the typed service's Call
and CallStream, and the generic `:stream` suffix. What each flow returns
must be equal between the packages. The `ray-tpu serve run` CLI
(TestCLI) waits for the port's scripts.py (ROADMAP A5c).
"""

import json
import sys
import textwrap
import urllib.request

import pytest

import ray_tpu
import ray_tpu.serve
import ray_tpu.serve.schema as jschema
import ray_tpu_torch
import ray_tpu_torch.serve
import ray_tpu_torch.serve.schema as tschema
from _torch_fixtures import _fresh_metric_registries  # noqa: F401

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
WAIT_S = 60
PACKAGES = ("ray_tpu_torch", "ray_tpu")

APP_MODULE = """
    from {package} import serve

    @serve.deployment(num_replicas=1)
    class Hello:
        def __init__(self, greeting="hi"):
            self.greeting = greeting

        def __call__(self, request):
            return {{"msg": f"{{self.greeting}} {{request.get('who', 'world')}}"}}

    app = Hello.bind("hello")

    def build(greeting="yo"):
        return Hello.bind(greeting)
"""


class Pkg:
    def __init__(self, name, module=None):
        self.port = name == "ray_tpu_torch"
        self.api = ray_tpu_torch if self.port else ray_tpu
        self.serve = ray_tpu_torch.serve if self.port else ray_tpu.serve
        self.schema = tschema if self.port else jschema
        self.module = module and module[name]

    def start(self):
        self.serve.shutdown()
        self.api.shutdown()
        self.api.init(num_cpus=4, system_config=dict(THREAD_MODE),
                      **({"num_gpus": 0} if self.port else {"num_tpus": 0}))

    def stop(self):
        self.serve.shutdown()
        self.api.shutdown()


@pytest.fixture
def app_module(tmp_path, monkeypatch):
    """One importable app module per package: {package name: module name}."""
    names = {}
    for package in PACKAGES:
        name = f"schema_app_{package}"
        (tmp_path / f"{name}.py").write_text(textwrap.dedent(APP_MODULE.format(package=package)))
        names[package] = name
    monkeypatch.syspath_prepend(str(tmp_path))
    yield names
    for name in names.values():
        sys.modules.pop(name, None)


def post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return json.loads(r.read())


def schema_view(cfg):
    return [(a.name, a.import_path, a.route_prefix, [vars(d) for d in a.deployments], a.args,
             a.kwargs) for a in cfg.applications], cfg.http_port


# ------------------------------------------------------- parse and build


def load_and_override(p, tmp_path, suffix):
    text = {"applications": [{"name": "hello", "import_path": f"{p.module}:app",
                              "deployments": [{"name": "Hello", "num_replicas": 2,
                                               "max_ongoing_requests": 16,
                                               "autoscaling_config": {"min_replicas": 1,
                                                                      "max_replicas": 3}}]}],
            "http_port": 0}
    path = tmp_path / f"{p.port}{suffix}"
    if suffix == ".json":
        path.write_text(json.dumps(text))
    else:
        yaml = pytest.importorskip("yaml")
        path.write_text(yaml.safe_dump(text))
    cfg = p.schema.ServeConfigSchema.load(str(path))
    app = p.schema.build_app(cfg.applications[0])
    c = app.deployment.config
    return (schema_view(cfg)[0][0][2:], app.deployment.name, c.num_replicas,
            c.max_ongoing_requests, vars(c.autoscaling_config), app.init_args)


def factories(p):
    kw = p.schema.build_app(p.schema.ApplicationSchema(
        name="b", import_path=f"{p.module}:build", kwargs={"greeting": "hey"}))
    args = p.schema.build_app(p.schema.ApplicationSchema(
        name="b", import_path=f"{p.module}:build", args=["salut"]))
    bound = p.schema.build_app(p.schema.ApplicationSchema(
        name="b", import_path=f"{p.module}:Hello", args=["hola"], kwargs={}))
    return [(a.deployment.name, a.init_args, a.init_kwargs) for a in (kw, args, bound)]


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_load_and_overrides_match_reference(suffix, app_module, tmp_path):
    port = load_and_override(Pkg("ray_tpu_torch", app_module), tmp_path, suffix)
    ref = load_and_override(Pkg("ray_tpu", app_module), tmp_path, suffix)
    assert port == ref
    assert port[1:4] == ("Hello", 2, 16) and port[5] == ("hello",)


def test_factories_match_reference(app_module):
    port, ref = (factories(Pkg(n, app_module)) for n in PACKAGES)
    assert port == ref
    assert [a[1] for a in port] == [("hey",), ("salut",), ("hola",)]


@pytest.mark.parametrize("raw,match", [
    ({"applications": [{"name": "x", "import_path": "m:a", "replicas": 3}]}, "replicas"),
    ({"applications": [{"name": "x", "import_path": "m:a",
                        "deployments": [{"name": "D", "num_replica": 1}]}]}, "num_replica"),
    ({"applications": [{"name": "spec", "import_path": "m:a",
                        "kwargs": {"speculation": {"mode": "telepathy"}}}]}, "app 'spec'"),
    ({"applications": [{"name": "nested", "import_path": "m:a",
                        "kwargs": {"engine_config": {"speculation": {"bogus": 1}}}}]},
     "app 'nested'"),
    ({"applications": [{"name": "dis", "import_path": "m:a",
                        "kwargs": {"disagg": {"kv_transfer": "carrier-pigeon"}}}]}, "app 'dis'"),
])
def test_validation_errors_match_reference(raw, match):
    errors = []
    for schema in (tschema, jschema):
        with pytest.raises(ValueError, match=match) as ei:
            schema.ServeConfigSchema.parse(raw)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


def test_parse_keeps_what_the_reference_keeps():
    raw = {"applications": [
        {"name": "a", "import_path": "m:a", "route_prefix": "/v1", "args": [1],
         "kwargs": {"speculation": {"mode": "ngram"}, "disagg": {"prefill_replicas": 2}},
         "deployments": [{"name": "D", "user_config": {"k": 1},
                          "ray_actor_options": {"num_cpus": 2}}]},
        {"name": "b", "import_path": "m:b"}], "http_port": 8123}
    assert schema_view(tschema.ServeConfigSchema.parse(raw)) == schema_view(
        jschema.ServeConfigSchema.parse(raw))


def test_bad_import_path_and_target_match_reference(app_module):
    for n in PACKAGES:
        schema = Pkg(n).schema
        with pytest.raises(ValueError, match="module:attribute"):
            schema.build_app(schema.ApplicationSchema(name="x", import_path="no_colon"))
        with pytest.raises(TypeError, match="expected an Application"):
            schema.build_app(schema.ApplicationSchema(name="x",
                                                      import_path="json:__doc__"))


# ------------------------------------------------------ apply and serve


def apply_and_routes(p, tmp_path):
    p.start()
    try:
        path = tmp_path / f"{p.port}-apply.json"
        path.write_text(json.dumps({"applications": [
            {"name": "hello", "import_path": f"{p.module}:app"}]}))
        status = p.schema.apply(p.schema.ServeConfigSchema.load(str(path)))
        port = p.serve.http_port()
        out = [sorted(status), post(port, "/hello", {"who": "schema"})["result"]]
        routed = p.schema.build_app(p.schema.ApplicationSchema(
            name="routed", import_path=f"{p.module}:app", route_prefix="/api/v9"))
        p.serve.run(routed, name="routed", route_prefix="/api/v9")
        out.append(post(port, "/api/v9", {"who": "router"})["result"])
        p.serve.delete("routed")
        rooted = p.schema.build_app(p.schema.ApplicationSchema(
            name="rooted", import_path=f"{p.module}:build", kwargs={"greeting": "yo"},
            route_prefix="/"))
        p.serve.run(rooted, name="rooted", route_prefix="/")
        out.append(post(port, "/", {"who": "root"})["result"])
        return out
    finally:
        p.stop()


def test_apply_serves_as_the_reference(app_module, tmp_path):
    port = apply_and_routes(Pkg("ray_tpu_torch", app_module), tmp_path)
    ref = apply_and_routes(Pkg("ray_tpu", app_module), tmp_path)
    assert port == ref
    assert port[1:] == [{"msg": "hello schema"}, {"msg": "hello router"}, {"msg": "yo root"}]


# ---------------------------------------------------------------- gRPC


def grpc_flows(p, app_module):
    grpc = pytest.importorskip("grpc")
    protos = __import__(f"{'ray_tpu_torch' if p.port else 'ray_tpu'}.serve.protos",
                        fromlist=["ServeRequest"])
    p.start()
    try:
        @p.serve.deployment
        class Typed:
            def __call__(self, x):
                return {"doubled": x["n"] * 2}

            def count(self, x):
                for i in range(x["upto"]):
                    yield {"i": i}

        app = p.schema.build_app(p.schema.ApplicationSchema(
            name="gapp", import_path=f"{p.module}:app"))
        p.serve.run(app, name="gapp", route_prefix="/gapp")
        p.serve.run(Typed.bind(), name="typed")
        port = p.serve.start_grpc()
        out = [port == p.serve.grpc_port(), port == p.serve.start_grpc()]
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            out.append(json.loads(channel.unary_unary("/gapp/__call__")(
                json.dumps({"who": "grpc"}).encode(), timeout=WAIT_S)))
            with pytest.raises(grpc.RpcError) as ei:
                channel.unary_unary("/nosuchapp/__call__")(b"{}", timeout=WAIT_S)
            out.append(ei.value.code().name)
            call = channel.unary_unary(
                "/ray_tpu.serve.RayServeAPI/Call",
                request_serializer=protos.ServeRequest.SerializeToString,
                response_deserializer=protos.ServeReply.FromString)
            out.append(json.loads(call(protos.ServeRequest(
                route="typed", payload=json.dumps({"n": 21}).encode()), timeout=WAIT_S).payload))
            stream = channel.unary_stream(
                "/ray_tpu.serve.RayServeAPI/CallStream",
                request_serializer=protos.ServeRequest.SerializeToString,
                response_deserializer=protos.ServeChunk.FromString)
            chunks = list(stream(protos.ServeRequest(
                route="typed", method="count", payload=json.dumps({"upto": 4}).encode()),
                timeout=WAIT_S))
            out.append((chunks[-1].final, [json.loads(c.payload) for c in chunks[:-1]]))
            generic = list(channel.unary_stream("/typed/count:stream")(
                json.dumps({"upto": 3}).encode(), timeout=WAIT_S))
            out.append((generic[-1], [json.loads(c) for c in generic[:-1]]))
        p.serve.shutdown()
        out.append(p.serve.grpc_port())
        return out
    finally:
        p.stop()


def test_grpc_ingress_matches_reference(app_module):
    port = grpc_flows(Pkg("ray_tpu_torch", app_module), app_module)
    ref = grpc_flows(Pkg("ray_tpu", app_module), app_module)
    assert port == ref
    assert port[:6] == [True, True, {"msg": "hello grpc"}, "NOT_FOUND", {"doubled": 42},
                        (True, [{"i": i} for i in range(4)])]
    assert port[6] == (b"[DONE]", [{"i": i} for i in range(3)]) and port[7] is None


def test_the_protos_are_the_references_classes():
    pytest.importorskip("google.protobuf")
    from ray_tpu.serve import protos as jprotos
    from ray_tpu_torch.serve import protos as tprotos

    for name in ("ServeRequest", "ServeReply", "ServeChunk"):
        assert getattr(tprotos, name) is getattr(jprotos, name)
