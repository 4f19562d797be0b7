"""Legacy v1 model server — the port's copy of
``mlrun_tpu/serving/v1_serving.py`` (``MLModelServer``), kept for API
parity; new code should subclass V2ModelServer.
"""

from __future__ import annotations

from .v2_serving import V2ModelServer


class MLModelServer(V2ModelServer):
    """v1-protocol server: body {"instances": [...]} → {"predictions": [...]}.

    Subclasses implement load() and predict(body) like the v1 API.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.protocol = "v1"

    def validate(self, request: dict, operation: str) -> dict:
        if "instances" not in request and "inputs" not in request:
            raise ValueError(
                "v1 request must contain an 'instances' field")
        return request

    def preprocess(self, request: dict, operation: str) -> dict:
        if "instances" in request and "inputs" not in request:
            request["inputs"] = request["instances"]
        return request

    def postprocess(self, response: dict) -> dict:
        if "outputs" in response:
            response["predictions"] = response.pop("outputs")
        return response
