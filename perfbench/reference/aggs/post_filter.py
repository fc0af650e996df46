"""The docs of the outer query that also match `query`: their count (by
weight) and the sub-aggs over them."""


def evaluate(ref, args, w):
    fw = w * ref.mask(args["query"])
    out = {"doc_count": int(fw.sum())}
    out.update(ref.sub_aggs(args.get("aggs", {}), fw))
    return out
