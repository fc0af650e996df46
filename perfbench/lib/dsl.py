"""JSON request trees -> the port's query and agg objects, by name.

A query node is {kind: {arg: value}}, built as the port's public class
`<Kind>Query(**args)` ("match_all" -> MatchAllQuery, "term" ->
TermQuery, "range" -> RangeQuery, "boolean" -> BooleanQuery); the args
"must", "should" and "must_not" hold lists of query nodes. An agg node
is {kind: {arg: value}}, built as the port's public `<kind>_agg(**args)`
(count_agg, sum_agg, terms_agg, facet_agg, post_filter_agg, ...); its
"aggs" arg holds the sub-aggs ({name: agg node}, passed as sub_aggs) and
its "query" arg a query node. So a mix may use any constructor the port
exports without a change here; the reference (perfbench/reference/)
reads the same trees.
"""

_QUERY_LISTS = ("must", "should", "must_not")


def query(tt, node: dict):
    (kind, args), = node.items()
    cls = getattr(tt, "".join(w.capitalize() for w in kind.split("_"))
                  + "Query")
    return cls(**{k: ([query(tt, c) for c in v] if k in _QUERY_LISTS
                      else v) for k, v in args.items()})


def aggs(tt, tree: dict) -> dict:
    return {name: agg(tt, node) for name, node in tree.items()}


def agg(tt, node: dict):
    (kind, args), = node.items()
    kw = {}
    for k, v in args.items():
        if k == "aggs":
            kw["sub_aggs"] = aggs(tt, v)
        elif k == "query":
            kw["query"] = query(tt, v)
        else:
            kw[k] = v
    return getattr(tt, f"{kind}_agg")(**kw)
