"""Serving runtime — the port's copy of ``mlrun_tpu/runtimes/serving.py``
(``ServingSpec``, ``ServingRuntime``: ``set_topology``, ``add_model``,
``deploy``).

The graph and its models serialize into the ``SERVING_SPEC_ENV`` spec
that ``serving/asgi.server_from_env`` reads in the deployed gateway;
``to_mock_server`` builds the same graph in this process.
"""

from __future__ import annotations

import json
from typing import Union

from ..common.runtimes_constants import RuntimeKinds
from ..serving.server import GraphServer
from ..serving.states import RootFlowStep, RouterStep, TaskStep
from .remote import RemoteRuntime, RemoteSpec


class ServingSpec(RemoteSpec):
    _dict_fields = RemoteSpec._dict_fields + [
        "graph", "parameters", "load_mode", "graph_initializer",
        "error_stream", "track_models", "secret_sources",
        "default_content_type",
    ]

    def __init__(self, graph=None, parameters=None, load_mode=None,
                 graph_initializer=None, error_stream=None, track_models=None,
                 secret_sources=None, default_content_type=None, **kwargs):
        super().__init__(**kwargs)
        self._graph = None
        self.graph = graph
        self.parameters = parameters or {}
        self.load_mode = load_mode
        self.graph_initializer = graph_initializer
        self.error_stream = error_stream
        self.track_models = track_models
        self.secret_sources = secret_sources or []
        self.default_content_type = default_content_type

    @property
    def graph(self):
        return self._graph

    @graph.setter
    def graph(self, graph):
        if graph is None:
            self._graph = None
        elif isinstance(graph, dict):
            from ..serving.states import step_from_dict

            self._graph = step_from_dict(graph)
        else:
            self._graph = graph

    def to_dict(self, exclude=None):
        out = super().to_dict(exclude=["graph"])
        if self._graph is not None:
            out["graph"] = self._graph.to_dict()
        return out


class ServingRuntime(RemoteRuntime):
    kind = RuntimeKinds.serving
    _nested_fields = {**RemoteRuntime._nested_fields, "spec": ServingSpec}

    def __init__(self, metadata=None, spec=None, status=None):
        super().__init__(metadata, spec, status)
        if not isinstance(self.spec, ServingSpec):
            self.spec = ServingSpec.from_dict(self.spec.to_dict())

    # -- graph building ----------------------------------------------------
    def set_topology(self, topology: str = "router", class_name=None,
                     engine: str | None = None, exist_ok: bool = False,
                     **class_args) -> Union[RouterStep, RootFlowStep]:
        """Set the graph topology: 'router' or 'flow'."""
        if self.spec.graph is not None and not exist_ok:
            raise ValueError("graph topology is already set; pass exist_ok")
        if topology == "router":
            step = RouterStep(class_name=class_name, class_args=class_args)
            root = RootFlowStep()
            step.name = "router"
            root._add_existing("router", step)
            step.responder = True
            self.spec.graph = root
            root._router = step
            return step
        if topology == "flow":
            root = RootFlowStep(engine=engine)
            self.spec.graph = root
            return root
        raise ValueError(f"unsupported topology '{topology}'")

    @property
    def graph(self):
        return self.spec.graph

    def _router(self, router_step: str | None = None) -> RouterStep:
        graph = self.spec.graph
        if graph is None:
            return self.set_topology("router")
        if router_step:
            # an explicitly named router wins (a flow may carry several);
            # a name that is not a router is an error
            step = (getattr(graph, "steps", None) or {}).get(router_step)
            if not isinstance(step, RouterStep):
                raise ValueError(
                    f"step {router_step!r} is not a router in the graph")
            return step
        if hasattr(graph, "_router"):
            return graph._router
        if isinstance(graph, RouterStep):
            return graph
        # a deserialized graph (hub yaml, a db round trip) has lost the
        # handle set_topology kept: a lone router step is the router (not
        # cached, so a later second router makes the lookup ambiguous)
        steps = getattr(graph, "steps", None) or {}
        routers = [step for step in steps.values()
                   if isinstance(step, RouterStep)]
        if len(routers) == 1:
            return routers[0]
        raise ValueError("graph topology is not a router")

    def add_model(self, key: str, model_path: str | None = None,
                  class_name=None, model_url: str | None = None,
                  handler: str | None = None, router_step: str | None = None,
                  **class_args) -> TaskStep:
        """Register a model on the router."""
        router = self._router(router_step)
        if model_path:
            class_args = dict(class_args)
            class_args["model_path"] = model_path
        route = TaskStep(class_name or "V2ModelServer", class_args,
                         handler, name=key)
        return router.add_route(key, route)

    def remove_models(self, keys: list[str] | None = None):
        self._router().clear_children(keys)

    def set_tracking(self, stream_path: str | None = None, batch: int | None = None,
                     sample: int | None = None, tracking_policy=None):
        """Turn on model-monitoring event tracking."""
        self.spec.track_models = True
        if stream_path:
            self.spec.parameters["log_stream"] = stream_path
        return self

    def with_secrets(self, kind: str, source):
        self.spec.secret_sources.append({"kind": kind, "source": source})
        return self

    # -- serving spec / server ---------------------------------------------
    def _get_serving_spec(self) -> dict:
        return {
            "function_uri": self.uri,
            "version": "v2",
            "parameters": self.spec.parameters,
            "graph": self.spec.graph.to_dict() if self.spec.graph else None,
            "load_mode": self.spec.load_mode,
            "verbose": self.verbose,
            "graph_initializer": self.spec.graph_initializer,
            "error_stream": self.spec.error_stream,
            "track_models": self.spec.track_models,
            "secret_sources": self.spec.secret_sources,
            "default_content_type": self.spec.default_content_type,
        }

    def to_mock_server(self, namespace: dict | None = None,
                       current_function="*", track_models: bool = False,
                       **kwargs) -> GraphServer:
        """An in-process server of this graph, for offline tests."""
        from ..serving.server import GraphContext

        server = GraphServer.from_dict(self._get_serving_spec())
        server.graph = self.spec.graph
        if track_models:
            server.track_models = True
        context = GraphContext(server=server)
        server.init_states(context, namespace=namespace or {}, is_mock=True)
        return server

    def deploy(self, project: str = "", tag: str = "", verbose: bool = False):
        """The graph into the ``SERVING_SPEC_ENV`` env, then deploy through
        the service."""
        self.set_env("SERVING_SPEC_ENV",
                     json.dumps(self._get_serving_spec(), default=str))
        return super().deploy(project, tag, verbose)
