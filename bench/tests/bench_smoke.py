"""Smoke-sized stand-ins of the benchmark's configurations and traffic, so
that a test run on the CPU drives the harness's whole path in seconds."""
from bench.harness import manifest

MAN = manifest.Manifest()

#: the smoke sizes of each configuration (the widths of the port's smoke
#: configs), as overrides of the port's config and of the file's run sizes
SIZES = {
    "xlstm350m": dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, vocab=500),
    "phi4mini": dict(n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256, vocab=640,
                     logits_chunk=32),
}


def config(name: str) -> dict:
    c = MAN.config(name)
    over = SIZES[name]
    c["overrides"] = dict(over)
    c["run"].update(over)
    c["run"]["head_dim"] = over["d_model"] // over["n_heads"]
    c["run"]["padded_vocab"] = -(-over["vocab"] // 256) * 256
    return c


def traffic(cell: str) -> dict:
    t = MAN.traffic(MAN.cell(cell)["traffic"])
    t.update(batch=2, seq_len=32, pool=4, trace_steps=2)
    return t


def cells(kind=None):
    return [w["name"] for w in MAN.bench["workloads"]
            if kind is None or MAN.traffic(w["traffic"])["kind"] == kind]
