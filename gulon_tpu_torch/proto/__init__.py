"""The index wire format: ``index.proto`` (the schema) and ``index_wire.py``
(its codec, without the protobuf library)."""
