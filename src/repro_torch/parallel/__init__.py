"""Distribution of the port's models over a ``DeviceMesh``: the reference's
``repro/parallel`` (mesh views, parameter and input specs)."""
