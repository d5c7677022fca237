"""Cloud stages, one module a kind, found by a configuration's
``cloud.kind``.  Each builds the program's backend through its public
constructor and states the plain reference of its search."""
