"""The port's own copy of the reference's data pipeline (``repro.data``)."""
