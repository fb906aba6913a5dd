"""The port's `log_event` against the JAX package's: one JSON line per event,
a field JSON cannot encode written as its repr, and no exception out of it
whatever it is given (JAX wraps the whole body, plotpointe_tpu/utils/
logging.py:18-38). Mirrors tests/test_infra.py::test_log_event_never_raises."""
import io
import json

import numpy as np
import pytest

from plotpointe_tpu.utils.logging import log_event as jax_log_event
from plotpointe_tpu_torch.utils.logging import log_event


class _Weird:
    pass


class _BadRepr:
    def __repr__(self):
        raise RuntimeError("no repr")


class _BadStr:
    def __str__(self):
        raise RuntimeError("no str")


def test_log_event_writes_one_json_line_like_jax():
    lines = []
    for fn in (log_event, jax_log_event):
        buf = io.StringIO()
        fn("test_event", run_id="r1", stream=buf, metric=1.5, arr=np.arange(3), obj=_Weird())
        lines.append(json.loads(buf.getvalue()))
    got, want = lines
    assert got.keys() == want.keys()
    for k in ("schema", "event", "run_id", "metric", "arr"):
        assert got[k] == want[k], k
    assert got["obj"].startswith("<") and "_Weird" in got["obj"]


@pytest.mark.parametrize("case", ["bytes_stream", "field_repr_raises", "run_id_str_raises"])
def test_log_event_never_raises(case):
    """Each input raised out of the port's log_event before; JAX's returns
    None on all three, and so does the port's now."""
    kw = {"bytes_stream": dict(stream=io.BytesIO()),
          "field_repr_raises": dict(stream=io.StringIO(), bad=_BadRepr()),
          "run_id_str_raises": dict(stream=io.StringIO(), run_id=_BadStr())}[case]
    assert jax_log_event("e", **kw) is None
    assert log_event("e", **kw) is None
    if case != "bytes_stream":
        assert kw["stream"].getvalue() == ""  # the line is dropped, as JAX drops it
