"""``repro_torch.df`` — the user-facing lazy DataFrame API of the port.

The torch counterpart of ``repro.df``.  Write ordinary dataframe code;
the planner and stage execution run underneath, on the card unless the
env asks for the CPU:

    import numpy as np
    import repro_torch.df as rdf
    from repro_torch.expr import col

    with rdf.session(parallelism=8):            # 8 ranks on the card
        df = rdf.read_numpy({"k": keys, "v": vals})
        out = (df[df.v * 2 > 5]
               .assign(v2=df.v + 1)
               .groupby("k").agg({"v2": ["sum", "mean"]})
               .sort_values("k"))
        print(out.explain())        # optimized plan, rules fired
        table = out.collect()       # a DistTable on the session's env

``session(device="cpu")`` runs the same code on the CPU.  Many
applications share the card through a query scheduler: inside
``session(scheduler=QueryScheduler(slots=8, gang_size=2))`` each
``collect()`` runs on a gang of stacked ranks carved for it
(``repro_torch.serve``).
"""

from ..expr import Expr, col, lit
from .frame import (DataFrame, GroupBy, from_pandas, from_table, read_csv,
                    read_numpy, read_parquet)
from .session import (get_active_scheduler, get_env, reset_default_env,
                      session, set_default_env)

__all__ = [
    "DataFrame", "GroupBy", "Expr", "col", "lit",
    "read_numpy", "from_pandas", "from_table", "read_parquet", "read_csv",
    "session", "get_env", "get_active_scheduler", "set_default_env",
    "reset_default_env",
]
