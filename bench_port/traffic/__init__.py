"""One driver per kind of traffic; a cell file's "kind" names it."""
