"""DataBunch — the universal record type.

A dict with attribute access, mirroring the reference's DataBunch
(pplib.py:142-152) so users migrating from PulsePortraiture find the
same ergonomics (`data.freqs` == `data['freqs']`).  Values are host
numpy arrays / scalars; device code receives explicit array arguments,
never a bunch.
"""


class DataBunch(dict):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.__dict__ = self

    def __repr__(self):
        keys = ", ".join(sorted(self.keys()))
        return f"DataBunch({keys})"
