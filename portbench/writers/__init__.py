"""One module a system writer, found by the configuration's "writer"."""
