"""Tiny sizes for CPU runs of the cells: the configurations' structure
at widths a test can hold, and the traffic mixes cut to match."""

import cells

DENSE = {"n_layers": 2, "embed_dim": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "mlp_dim": 128, "vocab_size": 512,
         "dtype": "float32"}
MOE = dict(DENSE, mlp_dim=96)


def full_cell(name: str):
    """The cell ``<config>.<traffic>`` at its own size."""
    try:
        return cells.resolve(name)
    except KeyError:
        return cells.from_files(*name.split(".", 1))


def cell(name: str):
    """The cell ``<config>.<traffic>`` (from BENCHMARK.json, or from its
    files where BENCHMARK.json does not list it), its mix cut to CPU
    size."""
    out = full_cell(name)
    mix = out.traffic
    if mix["kind"] == "chat_sessions":
        mix["engine"].update(slots=8, max_len=1024, page_size=16)
        mix["system_prompts"]["tokens"] = 128
        mix.update(request_rate_per_s=3.0, think_s_mean=0.5)
    elif mix["kind"] == "closed_batch":
        mix["engine"].update(slots=8, max_len=256, page_size=16)
        mix["clients"] = 8
        mix["prompt_tokens"].update(median=64, min=16, max=128)
        mix["output_tokens"].update(min=16, max=64)
    else:
        mix.update(batch=2, seq=128)
        mix["document_tokens"].update(median=64, min=8, max=256)
    return out


def sizes(name: str) -> dict:
    return MOE if name.startswith("mixtral") else DENSE
