"""Machine-learning side of the port; so far only the category label
store that ``.results`` files carry (``categorize.py``)."""
